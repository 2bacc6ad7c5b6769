"""The port's fault injection (``deepspeed_tpu_torch/faults.py``) against
the JAX package's, and its hooks in the port's tiers:

- the same rules and seed fire on the same opportunities in both
  packages (Python's seeded ``random`` streams, one a rule), and the
  plans' ledgers (``snapshot``) agree; a bad rule raises the same error;
- ``poll`` / ``inject`` and the process-wide install behave alike;
- ``aio_read`` / ``aio_write`` rules fail the port's aio ops at ``wait``;
- a ``kv_corrupt`` rule flips a byte after the crc is recorded, and the
  promotion's verify raises ``ChecksumError``;
- an exhausted ``sync_read`` below failing aio reads ends the param
  stream's ``_fence_retry`` in ``FatalStreamError`` with the paths of a
  flight-recorder postmortem; without the rule the synchronous fallback
  serves the same bytes.

Every test uninstalls its plan in a ``finally``."""

import numpy as np
import pytest
import torch

from deepspeed_tpu import faults as jf
from deepspeed_tpu_torch import faults as tf
from deepspeed_tpu_torch import request_trace as trt
from deepspeed_tpu_torch.config import FaultsConfig, KVTierConfig
from deepspeed_tpu_torch.inference import kv_tier as tkv

torch.set_num_threads(1)

PAGE_SHAPE = (2, 2, 8, 16)
KEYS = ["req-1", "req-2", "req-10", "abc", None]


def _rules(seed):
    rng = np.random.default_rng(seed)
    subs = ["slot", "kv_corrupt", "sync_read", "aio_read", "replica"]
    out = []
    for i in range(6):
        sub = subs[int(rng.integers(0, len(subs)))]
        r = {"subsystem": sub, "rate": float(rng.choice([1.0, 0.5, 0.2])),
             "after": int(rng.integers(0, 3))}
        if rng.random() < 0.5:
            r["count"] = int(rng.integers(1, 5))
        if sub != "aio_read" and rng.random() < 0.4:
            r["match"] = "req-1"
        if sub == "slot" and rng.random() < 0.3:
            r.update(mode="latency", latency_s=0.001)
        out.append(r)
    return out


def _schedule(mod, seed):
    plan = mod.FaultPlan(_rules(seed), seed=seed)
    rng = np.random.default_rng(100 + seed)
    fired = []
    for _ in range(400):
        sub = ["slot", "kv_corrupt", "sync_read", "aio_read", "replica",
               "burst"][int(rng.integers(0, 6))]
        key = KEYS[int(rng.integers(0, len(KEYS)))]
        fired.append([(r.subsystem, r.mode) for r in plan.fire(sub, key)])
    return fired, plan.snapshot()


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_fault_schedule_per_seed_matches_jax(seed):
    assert _schedule(tf, seed) == _schedule(jf, seed)


@pytest.mark.parametrize("rule", [
    {"subsystem": "gpu"}, {"subsystem": "slot", "mode": "explode"},
    {"subsystem": "slot", "rate": 0.0}, {"subsystem": "slot", "after": -1},
    {"subsystem": "slot", "count": 0},
    {"subsystem": "slot", "mode": "latency"},
    {"subsystem": "slot", "mode": "degrade"},
    {"subsystem": "aio_read", "match": "x"}, {"subsystem": "slot", "x": 1}])
def test_rule_validation_matches_jax(rule):
    with pytest.raises(Exception) as want:
        jf.FaultPlan([rule])
    with pytest.raises(type(want.value)) as got:
        tf.FaultPlan([rule])
    assert str(got.value) == str(want.value)
    with pytest.raises(type(want.value)):
        FaultsConfig.coerce({"rules": [rule]})


def test_install_poll_inject():
    plan = tf.FaultPlan([{"subsystem": "slot", "match": "b", "count": 1},
                         {"subsystem": "sync_read", "mode": "latency",
                          "latency_s": 0.001}])
    prev = tf.install_fault_plan(plan)
    try:
        assert tf.active_plan() is plan
        assert tf.poll("slot", "a") == (0.0, None)
        with pytest.raises(tf.InjectedFault) as e:
            tf.inject("slot", key="b")
        assert isinstance(e.value, IOError)
        assert tf.inject("slot", key="b") is False     # count spent
        assert tf.inject("sync_read") is True          # latency only
        assert plan.snapshot()["injected"] == 2
        assert tf.ensure_installed(plan) is False
    finally:
        tf.clear_fault_plan(plan)
        tf.install_fault_plan(prev)
    assert tf.active_plan() is prev


def test_aio_rules_fail_ops_at_wait(tmp_path):
    from deepspeed_tpu_torch.io.aio import AioHandle

    h = AioHandle(n_threads=2)
    src = str(tmp_path / "src.bin")
    data = np.arange(1024, dtype=np.uint8)
    data.tofile(src)
    rfd = h.open(src)
    wfd = h.open(str(tmp_path / "dst.bin"), write=True)
    plan = tf.FaultPlan([{"subsystem": "aio_read", "count": 1},
                         {"subsystem": "aio_write", "count": 1}])
    tf.install_fault_plan(plan)
    try:
        buf = np.zeros(1024, np.uint8)
        h.pread(rfd, buf, 0)
        h.pwrite(wfd, data, 0)
        assert h.wait() == 2                 # both injected
        assert not buf.any()                 # the read never ran
        h.pread(rfd, buf, 0)
        assert h.wait() == 0                 # count spent: a real read
        np.testing.assert_array_equal(buf, data)
    finally:
        tf.clear_fault_plan(plan)
        h.close(rfd)
        h.close(wfd)


def test_kv_corrupt_is_caught_by_the_promote_crc():
    pool = tkv.KVTierPool(KVTierConfig.coerce({"enabled": True}),
                          PAGE_SHAPE, torch.float32)
    rng = np.random.default_rng(0)
    k, v = (rng.standard_normal(PAGE_SHAPE).astype(np.float32)
            for _ in range(2))
    key = b"\x01" * 16
    plan = tf.FaultPlan([{"subsystem": "kv_corrupt", "count": 1}])
    tf.install_fault_plan(plan)
    try:
        pool.demote(key, k, v)
        pool.demote(b"\x02" * 16, k, v)          # count spent: intact
    finally:
        tf.clear_fault_plan(plan)
    bufs = [pool.read_sync(n, s, d) for n, s, d in
            zip(*pool.entry_meta(key))]
    with pytest.raises(tf.ChecksumError):
        pool.decode(key, bufs)
    good = b"\x02" * 16
    gk, gv = pool.decode(good, [pool.read_sync(n, s, d) for n, s, d in
                                zip(*pool.entry_meta(good))])
    np.testing.assert_array_equal(gk, k)


def _spilled_pool(tmp_path):
    page = 2 * int(np.prod(PAGE_SHAPE)) * 4
    pool = tkv.KVTierPool(KVTierConfig.coerce(dict(
        host_pool_bytes=page, nvme_dir=str(tmp_path / "nvme"))), PAGE_SHAPE,
        torch.float32)
    rng = np.random.default_rng(1)
    keys = [bytes([i]) * 16 for i in range(3)]
    pages = {}
    for key in keys:
        k, v = (rng.standard_normal(PAGE_SHAPE).astype(np.float32)
                for _ in range(2))
        pool.demote(key, k, v)
        pages[key] = (k, v)
    nvme = [key for key in keys if pool.location(key) == "nvme"]
    assert nvme
    return pool, nvme, pages


def test_exhausted_sync_read_raises_fatal_with_postmortem(tmp_path):
    from deepspeed_tpu_torch.param_stream import TierPageReader

    pool, nvme, _ = _spilled_pool(tmp_path)
    tracer = trt.RequestTracer(dump_dir=str(tmp_path / "flight"))
    tracer.event("kv_promote", "req", attrs={"pages": len(nvme)})
    plan = tf.FaultPlan([{"subsystem": "aio_read"},
                         {"subsystem": "sync_read"}])
    tf.install_fault_plan(plan)
    try:
        reader = TierPageReader(pool, nvme, to_device=lambda b, g: None,
                                retries=1, retry_backoff_s=0.0)
        with pytest.raises(tf.FatalStreamError) as e:
            list(reader.sweep(range(reader.n_groups),
                              primed=reader.presubmit(0)))
    finally:
        tf.clear_fault_plan(plan)
        pool.fence_all_reads()
    paths = e.value.postmortem_paths
    assert any(p.startswith(str(tmp_path / "flight")) for p in paths)
    assert reader.io_retries == 1
    assert plan.snapshot()["opportunities"]["sync_read"] >= 1
    del tracer


def test_sync_read_fallback_serves_the_same_bytes(tmp_path):
    from deepspeed_tpu_torch.param_stream import TierPageReader

    pool, nvme, pages = _spilled_pool(tmp_path)
    got = {}
    reader = TierPageReader(pool, nvme, to_device=lambda b, g: got.update(
        {g: [np.array(x) for x in b]}), retries=1, retry_backoff_s=0.0)
    plan = tf.FaultPlan([{"subsystem": "aio_read"}])
    tf.install_fault_plan(plan)
    try:
        list(reader.sweep(range(reader.n_groups),
                          primed=reader.presubmit(0)))
    finally:
        tf.clear_fault_plan(plan)
        pool.fence_all_reads()
    assert reader.sync_fallbacks == reader.n_groups
    for g in range(reader.n_groups):
        key = reader.group_keys(g)[0]
        k, v = pool.decode(key, got[g][:2])
        np.testing.assert_array_equal(k, pages[key][0])
        np.testing.assert_array_equal(v, pages[key][1])
