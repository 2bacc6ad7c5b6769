"""The port's environment report (``deepspeed_tpu_torch/env_report.py``,
the ``ds_report`` counterpart) on a host without a card: it renders, the
CUDA probe (kernel B10) reports ``[FAIL]`` with the reason instead of
emulating, and ``main`` returns 1."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from deepspeed_tpu_torch import env_report

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(env_report._build, "_nvcc", _no_nvcc)


def _no_nvcc():
    raise RuntimeError("nvcc not found")


def test_report_without_a_card(no_card):
    r = env_report.report()
    assert set(r["versions"]) >= {"python", "deepspeed_tpu_torch", "torch",
                                  "cuda", "numpy"}
    assert r["versions"]["torch"] == torch.__version__
    assert r["backend"]["name"] == "unavailable"
    assert r["backend"]["devices"] == []
    assert "CUDA is not available" in r["backend"]["error"]
    probe = r["ops"]["cuda probe"]
    assert probe == {"ok": False, "mode": "-",
                     "error": r["backend"]["error"]}
    assert r["ops"]["nvcc"]["ok"] is False
    assert "nvcc not found" in r["ops"]["nvcc"]["error"]


def test_main_renders_fail_and_returns_1(no_card, capsys):
    assert env_report.main() == 1
    out = capsys.readouterr().out
    assert "deepspeed_tpu_torch environment report (ref: ds_report)" in out
    assert "cuda probe [FAIL] -" in out
    assert "nvcc [FAIL]" in out
    # only the host rows (g++ and its libraries) may read [OKAY] here
    assert all(ln.split()[0] in ("csrc", "g++") for ln in out.splitlines()
               if "[OKAY]" in ln)


def test_render_marks_each_op():
    r = {"versions": {"torch": "x"},
         "backend": {"name": "cuda", "devices": ["H100"], "error": None},
         "ops": {"cuda probe": {"ok": True, "mode": "compiled",
                                "error": None},
                 "nvcc": {"ok": False, "mode": None, "error": "missing"}}}
    lines = env_report.render(r)
    assert any("cuda probe [OKAY] compiled" in ln for ln in lines)
    assert any("nvcc [FAIL]" in ln for ln in lines)
    assert any(ln.strip() == "device: H100" for ln in lines)
    assert any("missing" in ln for ln in lines)


def test_probe_plain_version_on_cpu_tensors():
    x = torch.arange(8 * 128, dtype=torch.float32).reshape(8, 128)
    before = env_report.env_probe.launches
    assert torch.equal(env_report.env_probe(x), 2 * x)
    assert env_report.env_probe.launches == before


def test_module_entry_point_runs():
    res = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.env_report"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin",
             "CUDA_VISIBLE_DEVICES": ""})
    assert "ds_report" in res.stdout
    assert res.returncode == (0 if "[FAIL]" not in res.stdout else 1)
