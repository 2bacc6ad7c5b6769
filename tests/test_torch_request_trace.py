"""The port's request tracing and flight recorder
(``deepspeed_tpu_torch/request_trace.py``) against the JAX package's: the
per-request sampling decisions, the ring's wrap and incremental polls, the
JSONL round trip, the Chrome export and the per-request breakdown of the
same seeded event sequence (explicit timestamps) are equal; bound tracers
tag their events alike; a postmortem dump writes every live recorder."""

import json

import numpy as np
import pytest
import torch

from deepspeed_tpu import config as jcfg
from deepspeed_tpu import request_trace as jrt
from deepspeed_tpu_torch import config as tcfg
from deepspeed_tpu_torch import request_trace as trt

torch.set_num_threads(1)

PHASES = ["queued", "admitted", "prefill_chunk", "first_token",
          "decode_batch", "preempt", "requeue", "kv_promote", "finish",
          "request_failed", "request_shed"]


def _events(seed, n=300):
    """A seeded, time-ordered event sequence of four requests' lives."""
    rng = np.random.default_rng(seed)
    t = 1_000_000
    out = []
    for _ in range(n):
        t += int(rng.integers(1_000, 2_000_000))
        req = int(rng.integers(0, 4))
        phase = PHASES[int(rng.integers(0, len(PHASES)))]
        attrs = {"active": int(rng.integers(1, 4))} \
            if phase == "decode_batch" else {"k": int(rng.integers(0, 9))}
        out.append((t, None if phase == "decode_batch" else req,
                    int(rng.integers(-1, 3)), phase, attrs))
    return out


@pytest.mark.parametrize("rate", [1.0, 0.5, 0.1, 0.0])
def test_sampling_decisions_match_jax(rate):
    j = jrt.RequestTracer(sample_rate=rate)
    t = trt.RequestTracer(sample_rate=rate)
    ids = list(range(200)) + [f"r{i}" for i in range(50)] + [("a", 1)]
    assert [t.sampled(i) for i in ids] == [j.sampled(i) for i in ids]
    assert t.enabled == j.enabled


def test_ring_wrap_and_incremental_poll_match_jax():
    evs = _events(3, n=50)
    rings = [mod.FlightRecorder(capacity=16) for mod in (jrt, trt)]
    for e in evs:
        for r in rings:
            r.append(e)
    j, t = rings
    assert t.events() == j.events() and t.dropped == j.dropped
    for cur in (0, 30, 40, 49, 50, 60):
        assert t.events_since(cur) == j.events_since(cur)
    assert t.tail(5) == j.tail(5)


@pytest.mark.parametrize("seed", [0, 1])
def test_exports_and_breakdown_match_jax(seed, tmp_path):
    evs = _events(seed)
    for name, mod in (("jax", jrt), ("torch", trt)):
        mod.write_jsonl(evs, str(tmp_path / f"{name}.jsonl"), reason="x")
    back = trt.read_jsonl(str(tmp_path / "torch.jsonl"))
    assert back == jrt.read_jsonl(str(tmp_path / "jax.jsonl"))
    assert [trt.event_to_dict(e) for e in evs] == \
        [jrt.event_to_dict(e) for e in evs]
    got, want = trt.events_to_chrome(evs), jrt.events_to_chrome(evs)
    # the export names its source package; the rest is the same trace
    assert got["otherData"].pop("source") == \
        "deepspeed_tpu_torch.request_trace"
    want["otherData"].pop("source")
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert json.dumps(trt.request_breakdown(evs), sort_keys=True,
                      default=str) == \
        json.dumps(jrt.request_breakdown(evs), sort_keys=True, default=str)


def test_bound_tracer_and_config_match_jax():
    for mod, cfg in ((jrt, jcfg), (trt, tcfg)):
        tr = mod.RequestTracer.from_config(cfg.TracingConfig.coerce(
            {"sample_rate": 1.0, "ring_capacity": 64}))
        b = tr.bind(replica="r0")
        b.event("queued", 7, attrs={"x": 1})
        (ev,) = tr.recorder.events()
        assert ev[1:4] == (7, -1, "queued")
        assert ev[4] == {"x": 1, "replica": "r0"}
    off = trt.RequestTracer.from_config(tcfg.TracingConfig.coerce(False))
    assert not off.enabled


def test_postmortem_dump_writes_live_recorders(tmp_path):
    tr = trt.RequestTracer(dump_dir=str(tmp_path))
    tr.event("queued", 1)
    tr.event("request_failed", 1, attrs={"error": "boom"})
    paths = trt.postmortem_dump("unit_test")
    mine = [p for p in paths if p.startswith(str(tmp_path))]
    assert len(mine) == 1
    back = trt.read_jsonl(mine[0])
    # the dump folds the process-wide comms logger first: an earlier test
    # in this process may have left comm records there
    kinds = [e[3] for e in back if not e[3].startswith("comm_")]
    assert kinds == ["queued", "request_failed"]
