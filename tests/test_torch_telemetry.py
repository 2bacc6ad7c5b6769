"""The port's telemetry (``deepspeed_tpu_torch/telemetry.py``) against the
JAX package's: the same seeded event sequences (counter increments, gauge
sets, histogram observations over ``LATENCY_BUCKETS_S`` and custom
buckets, made from a numpy seed) through both registries give equal
snapshots and byte-equal Prometheus text, which parses back the same in
both; a disabled registry is the no-op singleton in both; the exporter
writes the same exposition file, serves ``/metrics`` and providers on an
ephemeral port, and bridges into a csv monitor with JAX's tags; a span
records its histogram; the comms fan-in folds the port's CommsLogger."""

import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from deepspeed_tpu import monitor as jmon
from deepspeed_tpu import telemetry as jt
from deepspeed_tpu_torch import monitor as tmon
from deepspeed_tpu_torch import telemetry as tt
from deepspeed_tpu_torch.utils.trace import CommsLogger

torch.set_num_threads(1)

NAMES = ["serving_steps", "kv_tier_promoted_pages", "train_loss",
         "queue depth", "aio/read-bytes"]
BUCKETS = (0.5, 1.0, 2.0, 8.0)


def _drive(mod, seed, n=300):
    """One seeded event sequence through a fresh registry of ``mod``."""
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    for _ in range(n):
        kind = int(rng.integers(0, 4))
        name = NAMES[int(rng.integers(0, len(NAMES)))]
        v = float(rng.exponential(0.7))
        if kind == 0:
            reg.counter(f"{name}_total", "a counter").inc(v)
        elif kind == 1:
            reg.gauge(f"{name}_now", "a gauge").set(v - 0.5)
        elif kind == 2:
            reg.histogram(f"{name}_seconds", "latency",
                          mod.LATENCY_BUCKETS_S).observe(v)
        else:
            reg.histogram(f"{name}_size", "custom buckets",
                          BUCKETS).observe(v * 4)
    reg.gauge("odd_values").set(float("nan"))
    reg.gauge("odd_inf").set(float("inf"))
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snapshot_and_prometheus_text_match_jax(seed):
    j, t = _drive(jt, seed), _drive(tt, seed)
    js, ts = j.snapshot(), t.snapshot()
    assert json.dumps(ts, sort_keys=True, default=str) == \
        json.dumps(js, sort_keys=True, default=str)
    assert tt.LATENCY_BUCKETS_S == jt.LATENCY_BUCKETS_S
    text = t.prometheus_text()
    assert text == j.prometheus_text()
    got, want = tt.parse_prometheus_text(text), \
        jt.parse_prometheus_text(j.prometheus_text())
    assert json.dumps(got, sort_keys=True, default=str) == \
        json.dumps(want, sort_keys=True, default=str)


def test_kind_mismatch_and_disabled_registry_match_jax():
    for mod in (jt, tt):
        reg = mod.MetricsRegistry()
        reg.counter("x")
        with pytest.raises((TypeError, ValueError)):
            reg.gauge("x")
        off = mod.MetricsRegistry(enabled=False)
        assert off.counter("a") is mod.NULL_METRIC
        off.counter("a").inc(3)
        off.histogram("h").observe(1.0)
        with off.span("s"):
            pass
    assert tt.MetricsRegistry(enabled=False).snapshot() == \
        jt.MetricsRegistry(enabled=False).snapshot()
    assert tt.MetricsRegistry(enabled=False).prometheus_text() == \
        jt.MetricsRegistry(enabled=False).prometheus_text()


def test_span_records_its_histogram():
    reg = tt.MetricsRegistry()
    with reg.span("serving_step"):
        torch.ones(4).sum()
    h = reg.snapshot()["histograms"]["serving_step_seconds"]
    assert h["count"] == 1 and h["sum"] >= 0.0


def test_exporter_file_http_and_monitor_bridge(tmp_path):
    out = {}
    for name, mod, mon in (("jax", jt, jmon), ("torch", tt, tmon)):
        reg = _drive(mod, 7, n=50)
        d = tmp_path / name
        d.mkdir()
        m = mon.MonitorMaster({"csv_monitor": {
            "enabled": True, "output_path": str(d / "csv"),
            "job_name": "run"}})
        ex = mod.TelemetryExporter(
            reg, monitor=m, prometheus_path=str(d / "metrics.prom"),
            interval_s=0.0, http_port=0 if mod is tt else None)
        try:
            ex.maybe_export(step=3, force=True)
            if mod is tt:
                ex.register_provider("statusz", lambda: {"ok": 1})
                base = f"http://127.0.0.1:{ex.port}"
                with urllib.request.urlopen(base + "/metrics",
                                            timeout=10) as r:
                    assert r.read().decode() == reg.prometheus_text()
                with urllib.request.urlopen(base + "/statusz",
                                            timeout=10) as r:
                    assert json.loads(r.read()) == {"ok": 1}
        finally:
            ex.close()
            m.close()
        out[name] = d
    assert (out["torch"] / "metrics.prom").read_text() == \
        (out["jax"] / "metrics.prom").read_text()
    files = lambda d: sorted(  # noqa: E731
        os.path.relpath(os.path.join(r, f), d)
        for r, _, fs in os.walk(d / "csv") for f in fs)
    assert files(out["torch"]) == files(out["jax"]) != []
    for f in files(out["jax"]):
        assert (out["torch"] / f).read_text() == (out["jax"] / f).read_text()


def test_comms_fan_in_folds_the_port_logger():
    log = CommsLogger()
    log.record_event("all_reduce", 128, 0.5)
    log.record_event("all_reduce", 64, 0.25)
    reg = tt.MetricsRegistry()
    reg.fan_in_comms(log)
    reg.fan_in_comms(log)                 # delta-tracked: no double count
    c = reg.snapshot()["counters"]
    assert c["comm_all_reduce_calls"] == 2
    assert c["comm_all_reduce_bytes"] == 192
    assert c["comm_all_reduce_seconds"] == 0.75
