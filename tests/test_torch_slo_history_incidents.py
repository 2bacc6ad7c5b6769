"""The port's SLO tracker, metric history and incident manager
(``deepspeed_tpu_torch/{slo,history,incidents}.py``) against the JAX
package's, on the same seeded event sequences and one synthetic clock each
(the modules' injectable ``clock``), so every decision that depends on
time is the same in both:

- SLO: per-tier attainment, TTFT / deadline verdicts, burn rates, alert
  hysteresis, shed / fail accounting and goodput, in the tracker's
  snapshot, the registry's and the alerts it emits;
- history: the rings (downsampling, rates, histogram quantiles) sampled
  from the same registry trajectory;
- incidents: the trigger classes, dedup and caps, and the bundles'
  contents less wall times, paths and ring timestamps.
"""

import json

import numpy as np
import pytest
import torch

from deepspeed_tpu import config as jcfg
from deepspeed_tpu import history as jhist
from deepspeed_tpu import incidents as jinc
from deepspeed_tpu import request_trace as jrt
from deepspeed_tpu import slo as jslo
from deepspeed_tpu import telemetry as jtel
from deepspeed_tpu_torch import config as tcfg
from deepspeed_tpu_torch import history as thist
from deepspeed_tpu_torch import incidents as tinc
from deepspeed_tpu_torch import request_trace as trt
from deepspeed_tpu_torch import slo as tslo
from deepspeed_tpu_torch import telemetry as ttel

torch.set_num_threads(1)

PKGS = {"jax": (jcfg, jtel, jslo, jhist, jinc, jrt),
        "torch": (tcfg, ttel, tslo, thist, tinc, trt)}
# wall-clock and location fields the comparison leaves out
VOLATILE = {"t", "t_wall", "t_mono_ns", "path", "dir", "wall_time",
            "created", "pid", "host", "t_ns", "written_at", "file"}


class Clock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t


class RecordingTracer:
    enabled = True

    def __init__(self):
        self.events = []

    def event(self, phase, req=None, slot=-1, attrs=None):
        self.events.append((phase, req, dict(attrs or {})))


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in VOLATILE}
    if isinstance(x, (list, tuple)):
        return [_strip(v) for v in x]
    return x


def _same(a, b):
    assert json.dumps(_strip(a), sort_keys=True, default=str) == \
        json.dumps(_strip(b), sort_keys=True, default=str)


TIERS = {"gold": {"ttft_s": 0.5, "itl_s": 0.2, "deadline_s": 4.0,
                  "target": 0.9},
         "bronze": {"ttft_s": 3.0, "deadline_s": 20.0, "target": 0.5}}


def _slo_run(pkg, seed, n=400):
    cfg, tel, slo = PKGS[pkg][:3]
    clock = Clock()
    reg = tel.MetricsRegistry()
    tracer = RecordingTracer()
    tr = slo.SLOTracker(
        cfg.SLOConfig.coerce({"tiers": TIERS, "default_tier": "gold",
                              "window_s": 30.0,
                              "burn_windows_s": [10.0, 30.0],
                              "burn_threshold": 1.5}),
        reg, tracer=tracer, clock=clock)
    rng = np.random.default_rng(seed)
    live = []
    for i in range(n):
        clock.t += float(rng.exponential(0.2))
        op = rng.random()
        if op < 0.3 or not live:
            tier = None if rng.random() < 0.3 else \
                ("gold", "bronze")[int(rng.integers(0, 2))]
            tr.on_submit(i, tier)
            live.append(i)
        elif op < 0.7:
            tr.on_token(live[int(rng.integers(0, len(live)))])
        elif op < 0.85:
            tr.on_finish(live.pop(int(rng.integers(0, len(live)))))
        elif op < 0.92:
            tr.on_fail(live.pop(int(rng.integers(0, len(live)))))
        elif op < 0.96:
            tr.on_shed(f"s{i}", ("gold", "bronze")[int(rng.integers(0, 2))])
        else:
            tr.forget(live.pop(int(rng.integers(0, len(live)))))
        if i % 25 == 0:
            tr.maybe_refresh()
    return tr.snapshot(), reg.snapshot(), tracer.events


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_slo_verdicts_burn_and_goodput_match_jax(seed):
    j, t = _slo_run("jax", seed), _slo_run("torch", seed)
    for a, b in zip(t, j):
        _same(a, b)
    assert any(e[0] == "slo_burn_alert" for e in t[2]) or seed != 0


def test_slo_refusals_match_jax():
    for pkg in PKGS:
        cfg, tel, slo = PKGS[pkg][:3]
        tr = slo.SLOTracker(cfg.SLOConfig.coerce({"tiers": TIERS,
                                                  "default_tier": "gold"}),
                            tel.MetricsRegistry(), clock=Clock())
        with pytest.raises(ValueError, match="unknown SLO tier"):
            tr.on_submit("x", "platinum")
        assert slo.NULL_SLO_TRACKER.snapshot() == \
            PKGS["jax"][2].NULL_SLO_TRACKER.snapshot()


def _history_run(pkg, seed):
    cfg, tel, _, hist = PKGS[pkg][:4]
    clock = Clock()
    reg = tel.MetricsRegistry()
    h = hist.MetricHistory(
        cfg.HistoryConfig.coerce({"rings": [[1.0, 16], [4.0, 8]],
                                  "max_series": 8}), reg, clock=clock)
    rng = np.random.default_rng(seed)
    c = reg.counter("serving_decode_steps")
    g = reg.gauge("serving_queue_depth")
    hh = reg.histogram("serving_ttft_seconds", "", tel.LATENCY_BUCKETS_S)
    for t in range(60):
        clock.t = float(t)
        c.inc(float(rng.integers(0, 9)))
        g.set(float(rng.integers(0, 20)))
        for _ in range(int(rng.integers(0, 4))):
            hh.observe(float(rng.exponential(0.3)))
        h.sample()
    return h.snapshot()


@pytest.mark.parametrize("seed", [0, 1])
def test_history_rings_match_jax(seed):
    _same(_history_run("torch", seed), _history_run("jax", seed))


def _incidents_run(pkg, tmp_path):
    cfg, tel, slo, hist, inc, rt = PKGS[pkg]
    clock = Clock()
    reg = tel.MetricsRegistry()
    tracer = rt.RequestTracer(rt.FlightRecorder(4096))
    tr = slo.SLOTracker(
        cfg.SLOConfig.coerce({
            "tiers": {"default": {"ttft_s": 1e-9, "target": 0.5}},
            "window_s": 60.0, "burn_windows_s": [60.0],
            "burn_threshold": 1.0}), reg, tracer=tracer, clock=clock)
    h = hist.MetricHistory(cfg.HistoryConfig.coerce(
        {"sample_interval_s": 1.0}), reg, clock=clock)
    d = tmp_path / pkg
    d.mkdir()
    mgr = inc.IncidentManager(
        cfg.IncidentsConfig.coerce({
            "dir": str(d), "eval_interval_s": 1.0, "pre_window_s": 60.0,
            "detect": ["serving_queue_depth"], "min_samples": 10,
            "z_threshold": 4.0, "max_bundles": 4,
            "dedup_window_s": 30.0}),
        registry=reg, tracer=tracer, history=h, clock=clock)
    g = reg.gauge("serving_queue_depth")
    rng = np.random.default_rng(4)
    trips = []
    for t in range(40):
        clock.t = float(t)
        g.set(5.0 + float(rng.integers(0, 2)) * 0.5)
        h.sample()
        trips += mgr.evaluate()
    tr.on_submit("req1")
    clock.t = 41.0
    tr.on_token("req1")
    tr.on_finish("req1")                # violated -> burn alert
    clock.t = 42.0
    trips += mgr.evaluate()
    for t in (43, 44, 45, 46):          # a sustained excursion
        clock.t = float(t)
        g.set(500.0)
        h.sample()
        trips += mgr.evaluate()
    for i in range(10):                 # a storm inside the dedup window
        tracer.event("replica_dead", attrs={"replica": f"r{i}"})
    clock.t = 47.0
    trips += mgr.evaluate()
    clock.t = 48.0
    trips += mgr.evaluate()
    bundles = []
    for meta in mgr.bundles:
        with open(meta["path"]) as f:
            bundles.append(json.load(f))
    return trips, mgr.snapshot(), bundles


def test_incident_triggers_and_bundles_match_jax(tmp_path):
    jt, js, jb = _incidents_run("jax", tmp_path)
    tt, ts, tb = _incidents_run("torch", tmp_path)
    assert tt == jt and "slo_burn" in tt
    assert any(x.startswith("anomaly_") for x in tt)
    _same(ts, js)
    assert len(tb) == len(jb) > 1
    for a, b in zip(tb, jb):
        _same(a, b)
