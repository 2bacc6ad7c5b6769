"""Environment / op-compatibility report (port of ``deepspeed_tpu/
env_report.py``; ref: deepspeed ``ds_report``, which prints the torch and
CUDA versions and a table of which fused ops build on this machine).

Package versions, the CUDA backend and its devices, and whether the port's
CUDA kernels build and run here: the ``cuda probe`` builds the kernel
library (:mod:`~deepspeed_tpu_torch.ops._build`) and launches the probe
kernel B10 (``csrc/env_probe.cu``, replacing the JAX report's Pallas probe)
on one ``(8, 128)`` f32 tile.  Unlike the JAX report there is no interpret
mode: without a card the probe reports ``[FAIL]`` with the reason, it does
not emulate.  The host rows, as in the JAX report: whether the port's host
C++ libraries build with ``g++`` and load (``csrc (aio/hostruntime)``: the
aio pool and the host runtime, :mod:`~deepspeed_tpu_torch.io.aio` and
:mod:`~deepspeed_tpu_torch.io.native`; ``csrc (cpu_adam)``:
:mod:`~deepspeed_tpu_torch.ops.cpu_adam`), and ``g++`` itself.  Run as
``python -m deepspeed_tpu_torch.env_report`` or ``dstpu-torch-report``.
"""

from __future__ import annotations

import importlib
import importlib.util
import shutil
import sys

import numpy
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch._device import resolve_device
from deepspeed_tpu_torch.ops import _build

OKAY, FAIL = "[OKAY]", "[FAIL]"
PROBE_SHAPE = (8, 128)


def _version(mod: str) -> str:
    try:
        m = importlib.import_module(mod)
        return getattr(m, "__version__", "unknown")
    except Exception:
        return "not installed"


def env_probe_reference(x):
    """Plain version of B10: ``2 * x``."""
    return x * 2.0


def env_probe(x):
    """B10: ``2 * x`` over a contiguous f32 tile in one block.  CPU tensors
    take :func:`env_probe_reference`; CUDA tensors launch the kernel or
    raise."""
    if x.device.type == "cpu":
        return env_probe_reference(x)
    if not x.is_cuda or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"env_probe: want a contiguous float32 CUDA tensor, "
                         f"got {x.dtype} on {x.device}")
    out = torch.empty_like(x)
    err = _build.lib().dstt_env_probe(x.data_ptr(), out.data_ptr(),
                                      x.numel(), _build.stream_of(x))
    _build.check("dstt_env_probe", err)
    env_probe.launches += 1
    return out


env_probe.launches = 0


def _probe_backend():
    try:
        resolve_device(None)
        n = torch.cuda.device_count()
        return "cuda", [torch.cuda.get_device_name(i) for i in range(n)], \
            None
    except Exception as e:  # no CUDA runtime, no card, ...
        return "unavailable", [], str(e)


def _probe_cuda() -> tuple:
    """Build the kernel library, launch B10 on the card and check the tile
    exactly; (ok, mode, error)."""
    try:
        dev = resolve_device(None)
        x = torch.arange(PROBE_SHAPE[0] * PROBE_SHAPE[1], dtype=torch.float32,
                         device=dev).reshape(PROBE_SHAPE)
        out = env_probe(x)
        torch.cuda.synchronize(dev)
        return bool(torch.equal(out, env_probe_reference(x))), "compiled", \
            None
    except Exception as e:
        return False, "-", str(e)


def _probe_nvcc() -> tuple:
    try:
        return True, _build._nvcc(), None
    except Exception as e:
        return False, None, str(e)


def _probe_host_natives() -> tuple:
    """Build (or find) and load the aio and host-runtime libraries;
    (ok, error)."""
    try:
        from deepspeed_tpu_torch.io import aio, native

        missing = [name for name, mod in (("aio", aio),
                                          ("hostruntime", native))
                   if mod._ensure_lib() is None]
        return not missing, (f"{', '.join(missing)} did not build"
                             if missing else None)
    except Exception as e:
        return False, str(e)


def _probe_cpu_adam() -> tuple:
    try:
        from deepspeed_tpu_torch.ops.cpu_adam import native_available

        ok = native_available()
        return ok, None if ok else "cpu_adam did not build"
    except Exception as e:
        return False, str(e)


def report() -> dict:
    """Collect everything; the CLI renders this dict."""
    backend, devices, backend_err = _probe_backend()
    probe_ok, probe_mode, probe_err = _probe_cuda()
    nvcc_ok, nvcc_path, nvcc_err = _probe_nvcc()
    versions = {
        "python": sys.version.split()[0],
        "deepspeed_tpu_torch": deepspeed_tpu_torch.__version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "none",
        "numpy": numpy.__version__,
    }
    if importlib.util.find_spec("triton") is not None:
        versions["triton"] = _version("triton")
    return {
        "versions": versions,
        "backend": {"name": backend, "devices": devices,
                    "error": backend_err},
        "ops": {
            "cuda probe": {"ok": probe_ok, "mode": probe_mode,
                           "error": probe_err},
            "nvcc": {"ok": nvcc_ok, "mode": nvcc_path, "error": nvcc_err},
            "csrc (aio/hostruntime)": dict(zip(("ok", "error"),
                                               _probe_host_natives())),
            "csrc (cpu_adam)": dict(zip(("ok", "error"), _probe_cpu_adam())),
            "g++": {"ok": shutil.which("g++") is not None},
        },
    }


def render(r: dict) -> list:
    """The report as the lines :func:`main` prints."""
    rule = "-" * 60
    lines = [rule, "deepspeed_tpu_torch environment report (ref: ds_report)",
             rule]
    lines += [f"{name:>20}: {ver}" for name, ver in r["versions"].items()]
    lines.append(rule)
    b = r["backend"]
    lines.append(f"{'backend':>20}: {b['name']}")
    lines += [f"{'device':>20}: {d}" for d in b["devices"]]
    if b["error"]:
        lines.append(f"{'backend error':>20}: {b['error'][:120]}")
    lines.append(rule)
    for op, st in r["ops"].items():
        tag = OKAY if st["ok"] else FAIL
        lines.append(f"{op:>24} {tag} {st.get('mode') or ''}")
        if st.get("error"):
            lines.append(f"{'':>24}   {st['error'][:120]}")
    lines.append(rule)
    return lines


def main(argv=None) -> int:
    r = report()
    print("\n".join(render(r)))
    return 0 if all(st["ok"] for st in r["ops"].values()) else 1


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
