"""The training engine's telemetry and monitors in the port against the JAX
engine, on tiny Llama in f32 (a one-device JAX mesh):

- the csv monitor writes the files, tags and steps JAX's engine writes,
  its values (but the wall times) within rtol 1e-4 (the loss trajectory's own tolerance in
  tests/test_torch_train.py), less the ``comm_*`` counters (the process's
  comms loggers: the port's counts executed calls, JAX's its traces);
- the telemetry registry counts the steps and its snapshot carries JAX's
  counters, gauges and histograms, with the loss of the last step;
- telemetry, a monitor and a Prometheus sink leave the losses and the
  parameters bit for bit those of the engine without them;
- ``comms_digest`` writes its scalars to the monitor with JAX's tags;
- ``Watchdog`` and ``NanGuard`` behave as JAX's (the timeout fires the
  callback and the health view, a non-finite leaf skips the update)."""

import csv
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
import deepspeed_tpu as dstpu
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.topology import MeshSpec as JMesh
from deepspeed_tpu.utils import watchdog as jwd
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.utils import watchdog as twd
from deepspeed_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)
STEPS = 3
# the monitor's tags whose values are wall times or rates of them
TIMED = ("samples_per_sec", "step_seconds_mean", "step_seconds_sum")


def _config(out=None, **over):
    conf = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
            "gradient_clipping": 1.0, "bf16": {"enabled": False},
            "steps_per_print": 1,
            "optimizer": {"type": "adamw",
                          "params": {"lr": 3e-3, "weight_decay": 0.1}}}
    if out is not None:
        conf["csv_monitor"] = {"enabled": True, "output_path": str(out),
                               "job_name": "run"}
    conf.update(over)
    return conf


@pytest.fixture(scope="module")
def model():
    cfg = jl.LlamaConfig.tiny()
    return cfg, tl.LlamaConfig.tiny(), td.numpy_params(jl.init_params, cfg)


def _batches():
    rng = np.random.default_rng(0)
    return [{"tokens": rng.integers(0, 256, (4, 17)).astype(np.int32)}
            for _ in range(STEPS)]


def _port(model, conf):
    _, tcfg, host = model
    return initialize(loss_fn=tl.loss_fn(tcfg),
                      params=from_jax_params(host, device="cpu"),
                      config=conf, device="cpu")[0]


def _rows(d):
    out = {}
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f)) as fh:
            out[f] = list(csv.reader(fh))
    return out


def test_csv_monitor_and_registry_match_jax(model, tmp_path):
    cfg, _, host = model
    je = dstpu.initialize(
        loss_fn=jl.loss_fn(cfg), params=jax.tree.map(jnp.asarray, host),
        config=_config(tmp_path / "jax"),
        mesh=JMesh.build({"data": 1}, devices=jax.devices()[:1]))[0]
    te = _port(model, _config(tmp_path / "torch",
                              telemetry={"prometheus_path":
                                         str(tmp_path / "m.prom")}))
    for b in _batches():
        je.train_batch({k: jnp.asarray(v) for k, v in b.items()})
        te.train_batch(b)
    je.monitor.flush()
    want = _rows(tmp_path / "jax" / "run")
    got = _rows(tmp_path / "torch" / "run")
    # the comm_* counters fold in the process-wide comms logger: the
    # port's counts every executed collective call (its world-1 reductions
    # too), JAX's its traces, and in a shared test process either holds
    # what earlier tests recorded, so those files are left out on both
    assert {f for f in got if f.startswith("Telemetry_comm_")}
    got, want = ({f: r for f, r in rows.items()
                  if not f.startswith("Telemetry_comm_")}
                 for rows in (got, want))
    assert sorted(got) == sorted(want)
    assert {"Train_loss.csv", "Train_lr.csv",
            "Train_grad_norm.csv"} <= set(got)
    for f in want:
        assert got[f][0] == want[f][0]                       # header
        assert [r[0] for r in got[f]] == [r[0] for r in want[f]]
        if any(w in f for w in TIMED):
            continue                          # wall times: not comparable
        np.testing.assert_allclose(
            [float(r[1]) for r in got[f][1:]],
            [float(r[1]) for r in want[f][1:]], rtol=1e-4, atol=1e-6,
            err_msg=f)
    js, ts = je.telemetry_snapshot(), te.telemetry_snapshot()
    assert ts["counters"]["train_steps"] == js["counters"]["train_steps"] \
        == STEPS
    for kind in ("counters", "gauges", "histograms"):
        assert {k for k in ts[kind] if not k.startswith("comm_")} == \
            {k for k in js[kind] if not k.startswith("comm_")}, kind
    assert ts["histograms"]["train_step_seconds"]["count"] == STEPS
    np.testing.assert_allclose(ts["gauges"]["train_loss"],
                               js["gauges"]["train_loss"], rtol=1e-5)
    assert (tmp_path / "m.prom").exists()
    d = te.comms_digest(_batches()[0])
    te.monitor.flush()
    with open(tmp_path / "torch" / "run" / "Comms_total_bytes.csv") as f:
        assert float(list(csv.reader(f))[-1][1]) == d["total_bytes"]


def test_telemetry_and_monitors_leave_the_step_bit_for_bit(model, tmp_path):
    plain = _port(model, _config(telemetry={"enabled": False}))
    watched = _port(model, _config(tmp_path, telemetry={
        "enabled": True, "step_sync": True,
        "prometheus_path": str(tmp_path / "m.prom")}))
    for b in _batches():
        assert torch.equal(plain.train_batch(b), watched.train_batch(b))
    for a, b in zip(td._flatten(plain.module_params()).values(),
                    td._flatten(watched.module_params()).values()):
        np.testing.assert_array_equal(td._np(a), td._np(b))
    assert not plain.registry.enabled and watched.monitor.enabled


def test_watchdog_fires_and_reports_like_jax():
    fired = threading.Event()
    for mod in (jwd, twd):
        wd = mod.Watchdog(timeout_s=0.05, poll_s=0.01,
                          abort_on_timeout=False, on_timeout=fired.set)
        with wd:
            assert fired.wait(5.0)
        assert wd.fired and set(wd.health()) == {
            "fired", "timeout_s", "last_heartbeat_age_s"}
        fired.clear()
    wd = twd.Watchdog(timeout_s=60.0, poll_s=0.01, abort_on_timeout=False)
    with wd:
        wd.pet()
        assert not wd.fired and wd.last_pet_age_s() < 60.0


def test_nan_guard_matches_jax():
    rng = np.random.default_rng(1)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": [rng.normal(size=(2,)).astype(np.float32),
                  np.arange(3, dtype=np.int32)]}
    for poison in (None, ("a", 1, 2), ("b", 0, None)):
        t = jax.tree.map(np.copy, tree)
        if poison is not None:
            leaf = t[poison[0]] if poison[0] == "a" else t["b"][0]
            leaf[(poison[1], poison[2]) if poison[2] is not None
                 else poison[1]] = np.inf
        want = bool(jwd.NanGuard.all_finite(jax.tree.map(jnp.asarray, t)))
        tt = jax.tree.map(torch.from_numpy, t)
        assert bool(twd.NanGuard.all_finite(tt)) == want
        new = jax.tree.map(lambda x: x + 1, tt)
        kept = twd.NanGuard.where_finite(tt, new, tt)
        assert torch.equal(kept["a"], new["a"] if want else tt["a"])
