"""The port's devprof, FLOPs profiler and monitors
(``deepspeed_tpu_torch/{devprof,profiler,monitor}.py``) against the JAX
package's, on the CPU:

- devprof's host bookkeeping is the JAX module's: the compile ledger's
  schema and warmup / steady split, the deterministic sampling stride,
  the roofline tick on a synthetic clock, the incident probe's cursor and
  the status blocks' keys.  What the JAX module reads from XLA the port
  reads from its own: the compile ledger reports zero (no jit), a sampled
  phase is timed
  by ``begin`` / ``end`` (CUDA events on the card, the wall clock here),
  and ``capture`` writes a ``torch.profiler`` Chrome trace;
- the FLOPs profiler counts a matmul's FLOPs as XLA's cost analysis does;
- the csv monitor writes the files and rows JAX's writes; wandb enables or
  disables itself as JAX's does (tensorboard's gate is the same import
  test; it is left out here, where its import takes seconds)."""

import json
import os

import pytest
import torch

from deepspeed_tpu import devprof as jdp
from deepspeed_tpu import monitor as jmon
from deepspeed_tpu import profiler as jprof
from deepspeed_tpu.config import DevprofConfig as JDevprofConfig
from deepspeed_tpu.telemetry import MetricsRegistry as JRegistry
from deepspeed_tpu_torch import devprof as tdp
from deepspeed_tpu_torch import monitor as tmon
from deepspeed_tpu_torch import profiler as tprof
from deepspeed_tpu_torch.config import DevprofConfig
from deepspeed_tpu_torch.telemetry import MetricsRegistry

torch.set_num_threads(1)


def _pair(**kw):
    kw.setdefault("enabled", True)
    j = jdp.DevProf(JDevprofConfig.coerce(dict(kw)), registry=JRegistry())
    t = tdp.DevProf(DevprofConfig.coerce(dict(kw)),
                    registry=MetricsRegistry(), device="cpu")
    return j, t


def test_vocabulary_and_ledger_match_jax():
    assert tdp.PHASES == jdp.PHASES
    assert tdp.PHASE_ALIASES == jdp.PHASE_ALIASES
    for name in list(jdp.PHASE_ALIASES) + ["decode", "unknown_site"]:
        assert tdp.canonical_phase(name) == jdp.canonical_phase(name)
    for mod in (jdp, tdp):
        led = mod.CompileLedger(capacity=3)
        for i in range(5):
            led.record(f"s{i}", steady=i >= 3, n=2, duration_s=0.5)
        s = led.snapshot()
        assert (s["warmup_compiles"], s["steady_state_compiles"]) == (6, 4)
        assert [e["site"] for e in s["entries"]] == ["s2", "s3", "s4"]
        assert set(s["entries"][0]) == {"site", "t", "t_monotonic",
                                        "phase", "n", "duration_s"}


@pytest.mark.parametrize("rate", [1.0, 0.5, 0.25, 0.0])
def test_sampling_stride_matches_jax(rate):
    j, t = _pair(sample_rate=rate)
    for phase in ("decode", "prefill", "decode", "sample") * 9:
        assert t.should_sample(phase) == j.should_sample(phase)


def test_roofline_tick_and_cost_accounting_match_jax():
    j, t = _pair()
    for dp in (j, t):
        dp.peak_flops, dp.peak_bw = 1e12, 1e11
        dp.register_cost("decode_chunk", 4e9, 2e8)
        f = dp.wrap("decode_chunk", lambda x: x + 1)
        dp.tick(now=100.0)
        for _ in range(5):
            assert f(1) == 2
        dp.tick(now=100.2)                 # rate-limited: no change
        dp.tick(now=102.0)
    js, ts = j.statusz_block(), t.statusz_block()
    for key in ("mfu", "mbu", "flops_total", "bytes_total", "cost_sites"):
        assert ts[key] == js[key], key
    assert set(ts) == set(js)


def test_compile_ledger_reports_zero_and_keeps_the_probe():
    j, t = _pair()
    assert t.monitoring is False
    led = t.bundle_info()["compile_ledger"]
    assert set(led) == set(j.bundle_info()["compile_ledger"])
    assert (led["warmup_compiles"], led["steady_state_compiles"]) == (0, 0)
    assert led["entries"] == []
    block = t.statusz_block()
    assert block["compiles_warmup"] == block["compiles_steady"] == 0
    # the ledger's entry point keeps JAX's contract, should a source call it
    t.on_compile("site", 1, 0.25)
    assert t.incident_probe() is None        # warmup: no trip
    t.mark_steady()
    t.on_compile("site", 1, 0.5)
    kind, info = t.incident_probe()
    assert kind == "steady_state_recompile"
    assert info["new_compiles"] == 1 and t.incident_probe() is None
    led = t.bundle_info()["compile_ledger"]
    assert (led["warmup_compiles"], led["steady_state_compiles"]) == (1, 1)
    assert [e["duration_s"] for e in led["entries"]] == [0.25, 0.5]
    c = t.registry.snapshot()["counters"]
    assert c["devprof_compiles_warmup"] == c["devprof_compiles_steady"] == 1


def test_begin_end_attribute_device_time_per_phase():
    _, t = _pair(sample_rate=0.5)
    assert t.begin("decode") is None         # the stride's first skip
    tk = t.begin("decode")
    torch.ones(64, 64) @ torch.ones(64, 64)
    dt = t.end(tk)
    assert dt > 0.0
    block = t.statusz_block()
    assert block["device_seconds"]["decode"] == round(dt, 6)
    assert t.registry.snapshot()["counters"][
        "devprof_sampled_dispatches"] == 1
    assert tdp.NULL_DEVPROF.begin("decode") is None
    assert tdp.NULL_DEVPROF.end(None) == 0.0


def test_capture_writes_a_chrome_trace(tmp_path):
    t = tdp.DevProf(DevprofConfig.coerce({"enabled": True}),
                    registry=MetricsRegistry(), dump_dir=str(tmp_path),
                    device="cpu")
    out = t.profilez(capture_s=0.05)
    assert os.path.exists(out["trace"])
    with open(out["trace"]) as f:
        assert "traceEvents" in json.load(f)
    assert out["devprof"]["captures"][0]["path"] == out["path"]
    json.dumps(out)


def test_matmul_flops_match_xla_cost_analysis():
    import jax.numpy as jnp

    a, b = torch.ones(32, 64), torch.ones(64, 16)
    got = tprof.counted_cost(lambda x, y: x @ y, a, b)
    want = jprof.xla_cost_analysis(lambda x, y: x @ y,
                                   jnp.ones((32, 64)), jnp.ones((64, 16)))
    assert got["flops"] == want["flops"] == 2 * 32 * 64 * 16
    assert tprof.transformer_decode_flops(1e6, 2, 64, 128) == \
        jprof.transformer_decode_flops(1e6, 2, 64, 128)
    prof = tprof.get_model_profile(lambda x, y: x @ y, (a, b),
                                   params={"w": a}, print_profile=False)
    assert prof["flops"] == want["flops"] and prof["params"] == a.numel()
    assert prof["latency_s"] > 0 and prof["mfu"] > 0


def test_csv_monitor_rows_and_optional_backends_match_jax(tmp_path):
    events = [("Train/loss", 2.5, 1), ("Train/lr", 1e-3, 1),
              ("Train/loss", 2.25, 2), ("Comms/all-reduce_bytes", 4096, 2)]
    for name, mod in (("jax", jmon), ("torch", tmon)):
        m = mod.MonitorMaster({
            "csv_monitor": {"enabled": True,
                            "output_path": str(tmp_path / name),
                            "job_name": "run"},
            "wandb": {"enabled": True}})
        m.write_events(events)
        m.write_scalars({"Train/samples_per_sec": 10.0}, 3)
        m.flush()
        m.close()
        kinds = sorted(type(b).__name__ for b in m.backends)
        if name == "jax":
            want = kinds
    assert kinds == want and "CsvMonitor" in kinds

    def files(d):
        return sorted(os.path.relpath(os.path.join(r, f), d)
                      for r, _, fs in os.walk(d) for f in fs)

    assert files(tmp_path / "torch") == files(tmp_path / "jax") != []
    for f in files(tmp_path / "jax"):
        assert (tmp_path / "torch" / f).read_text() == \
            (tmp_path / "jax" / f).read_text()
