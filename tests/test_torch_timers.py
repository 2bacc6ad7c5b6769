"""The port's timers against the JAX package's under one scripted
``time.perf_counter``: the same elapsed times, means and counts, the same
errors (double start, stop before start), ``elapsed(reset)``, the registry's
log line, and ``ThroughputTimer``'s rates with its ``start_step`` skip and
MFU against the nominal CPU peak."""

import pytest
import torch

from deepspeed_tpu import timers as jt
from deepspeed_tpu_torch import timers as tt

torch.set_num_threads(1)


@pytest.fixture
def clock(monkeypatch):
    """A scripted ``time.perf_counter`` (both packages read the one
    ``time`` module) reading 0.0, 0.5, 1.25, 2.25, ... (steps growing by
    0.25 s); calling the fixture's value starts the script again."""
    state = {}

    def script():
        t, step = 0.0, 0.5
        while True:
            yield t
            t, step = t + step, step + 0.25

    def restart():
        state["it"] = script()

    restart()
    monkeypatch.setattr(tt.time, "perf_counter", lambda: next(state["it"]))
    return restart


def _drive_timer(mod, **kw):
    reg = mod.SynchronizedWallClockTimer(**kw)
    out = []
    t = reg("fwd")
    t.start()
    with pytest.raises(RuntimeError, match="already started"):
        t.start()
    t.stop()
    t.start()
    t.stop()
    out += [t.count, t.mean(), t.elapsed(reset=False), t.count]
    t.start()
    t.stop(reset=True)
    out += [t.elapsed(reset=True), t.count, t.elapsed(), t.mean()]
    with pytest.raises(RuntimeError, match="not started"):
        t.stop()
    b = reg("bwd")
    b.start()
    b.stop()
    out.append(reg.log(reset=False))
    out.append(reg.log(names=["bwd", "nope"]))
    return out


def test_wall_clock_timers_match_jax(clock):
    want = _drive_timer(jt)
    clock()
    got = _drive_timer(tt, device="cpu")
    assert got == want


def _drive_throughput(mod, **kw):
    tp = mod.ThroughputTimer(batch_size=4, seq_len=128,
                             flops_per_sample=3e9, start_step=2, **kw)
    rows = []
    for _ in range(5):
        tp.start()
        tp.stop()
        rows.append((tp.step_count, tp.total_samples, tp.total_time,
                     tp.samples_per_sec, tp.tokens_per_sec, tp.tflops,
                     tp.mfu))
    rows.append(tp.summary())
    bare = mod.ThroughputTimer(batch_size=2, **kw)
    rows.append(bare.summary())
    return rows


def test_throughput_timer_matches_jax(clock):
    want = _drive_throughput(jt)
    clock()
    got = _drive_throughput(tt, device="cpu")
    assert got == want
    assert got[-2]["steps"] == 3.0


def test_peak_tables_name_the_h100_and_the_cpu():
    assert tt.PEAK_FLOPS == {"h100": 989e12, "cpu": 1e12}
    assert tt.PEAK_HBM_BW == {"h100": 3.35e12, "cpu": 0.1e12}
    assert tt.device_peak_flops("cpu") == jt.PEAK_FLOPS["cpu"]
    assert tt.device_peak_bandwidth("cpu") == jt.PEAK_HBM_BW["cpu"]


def test_cuda_timers_refuse_a_host_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tt.SynchronizedWallClockTimer(),
                 lambda: tt.ThroughputTimer(batch_size=1),
                 lambda: tt.device_peak_flops()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert tt._Timer("x", "cpu").device.type == "cpu"
