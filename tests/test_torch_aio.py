"""The port's host aio pool (``deepspeed_tpu_torch/csrc/host/aio.cpp``,
built with g++ here) and the tiers over it (``infinity._RamTier`` /
``_NvmeTier``), against the JAX package's tiers.

The lost-wakeup repair (C-w5: a worker lowers ``pending_`` and notifies
under the pool's mutex, so a completion cannot land between ``Wait()``'s
predicate test and its sleep) is held by a stress test of racing
completions against ``Wait()``.  Every wait here runs in a worker thread
joined with a timeout, so a regression fails instead of hanging the run.
The JAX NVMe tier runs on its pure-Python aio arm (its native pool is not
driven); the byte comparisons are exact.
"""

import functools
import os
import sys
import threading

import numpy as np
import pytest
import torch

import deepspeed_tpu.infinity as jinf
import deepspeed_tpu.io.aio as jaio
from deepspeed_tpu_torch import infinity as tinf
from deepspeed_tpu_torch.io import aio as taio

torch.set_num_threads(1)

# a bound far above the work (milliseconds on this host)
WAIT_S = 120


def bounded(test):
    """Decorator for a test that drives the aio pool: its body runs in a
    worker thread joined with a timeout, so a stuck wait fails the test
    instead of hanging the run (the other port tests that read or write
    through aio import it from here)."""
    @functools.wraps(test)
    def run(*args, **kwargs):
        _bounded(lambda: test(*args, **kwargs), timeout=300)
    return run


def _bounded(fn, timeout=WAIT_S):
    """Run ``fn`` in a worker thread joined with ``timeout``; fail (not
    hang) when it does not finish, and re-raise what it raised."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # handed to the test thread below
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"aio work still blocked after {timeout} s"
    if "err" in box:
        raise box["err"]
    return box.get("out")


@pytest.fixture(autouse=True)
def python_arm_for_jax(monkeypatch):
    monkeypatch.setattr(jaio, "_ensure_lib", lambda: None)


def test_builds_natively_from_the_ports_source():
    h = taio.AioHandle(2)
    assert h.native
    assert os.path.exists(taio._LIB)


def test_source_notifies_under_the_lock():
    """The repaired completion path: decrement and notify inside a
    ``lock_guard`` on ``mu_``."""
    src = open(taio._SRC).read()
    run = src[src.index("void Run()"):src.index("std::mutex mu_;")]
    tail = run[run.index("if (failed)"):]
    assert "std::lock_guard<std::mutex> lk(mu_);" in tail
    assert tail.index("lock_guard") < tail.index("pending_.fetch_sub")


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_racing_completions_against_wait(tmp_path, native, monkeypatch):
    """Many short reads on many workers completing while ``wait`` tests
    and sleeps, with a short interpreter switch interval: every wait
    returns (bounded) and every read lands."""
    if not native:
        monkeypatch.setattr(taio, "_ensure_lib", lambda: None)
    path = tmp_path / "f.bin"
    data = np.arange(4096, dtype=np.uint8)
    path.write_bytes(data.tobytes())
    h = taio.AioHandle(8)
    assert h.native is native
    fd = h.open(str(path))
    bufs = [np.zeros(64, np.uint8) for _ in range(8)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def cycles():
            errs = 0
            for i in range(2000 if native else 200):
                for j, b in enumerate(bufs):
                    h.pread(fd, b, 64 * ((i + j) % 64))
                errs += h.wait()
                assert h.pending() == 0
            return errs

        threads_errs = [0]

        def many():
            # two submitters on two handles race their own waits too
            h2 = taio.AioHandle(8)
            fd2 = h2.open(str(path))
            b2 = np.zeros(128, np.uint8)
            t = threading.Thread(target=lambda: [
                (h2.pread(fd2, b2, 0), h2.wait()) for _ in range(500)])
            t.start()
            threads_errs[0] = cycles()
            t.join(WAIT_S)
            assert not t.is_alive()
            h2.close(fd2)

        _bounded(many)
    finally:
        sys.setswitchinterval(old)
    assert threads_errs[0] == 0
    i = (2000 if native else 200) - 1
    for j, b in enumerate(bufs):
        off = 64 * ((i + j) % 64)
        np.testing.assert_array_equal(b, data[off:off + 64])
    h.close(fd)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_round_trips(tmp_path, native, monkeypatch):
    if not native:
        monkeypatch.setattr(taio, "_ensure_lib", lambda: None)
    h = taio.AioHandle(4)
    rng = np.random.default_rng(0)
    a = rng.standard_normal((33, 17)).astype(np.float32)
    b = torch.from_numpy(rng.standard_normal(1000).astype(np.float32)) \
        .to(torch.bfloat16)
    p = str(tmp_path / "x.bin")
    fd = h.open(p, write=True)
    h.pwrite(fd, a, 0)
    h.pwrite(fd, b, a.nbytes)
    assert _bounded(h.wait) == 0
    h.close(fd)
    ra, rb = np.empty_like(a), torch.empty_like(b)
    fd = h.open(p)
    h.pread(fd, ra, 0)
    h.pread(fd, rb, a.nbytes)
    assert _bounded(h.wait) == 0
    h.close(fd)
    np.testing.assert_array_equal(ra, a)
    assert torch.equal(rb, b)
    # a read past the end fails as an error count, not a hang
    fd = h.open(p)
    h.pread(fd, np.empty(64, np.uint8), os.path.getsize(p) + 10)
    assert _bounded(h.wait) == 1
    h.close(fd)


def test_rejects_buffers_it_cannot_write_through():
    h = taio.AioHandle(1)
    with pytest.raises(ValueError):
        h.pread(0, np.zeros((4, 4), np.float32)[:, ::2])
    with pytest.raises(ValueError):
        h.pread(0, torch.zeros(4, 4).t())
    with pytest.raises(ValueError):
        h.pread(0, [1, 2, 3])


def test_priority_group():
    g = taio.AioPriorityGroup()
    pending = {"hi": 0, "lo": 0}
    g.register(lambda: pending["hi"], 1)
    g.register(lambda: pending["lo"], 0)
    assert not g.busy_above(0)
    pending["hi"] = 3
    assert g.busy_above(0) and not g.busy_above(1)
    pending["lo"] = 5
    assert not g.busy_above(1)
    j = jaio.AioPriorityGroup()
    j.register(lambda: pending["hi"], 1)
    assert j.busy_above(0) == g.busy_above(0)


def _leaves(rng):
    return {"w": rng.standard_normal((8, 16)).astype(np.float32),
            "n": rng.integers(-9, 9, (5,)).astype(np.int8),
            "s": rng.standard_normal((3, 4)).astype(np.float32)}


def test_ram_tier_matches_jax():
    rng = np.random.default_rng(1)
    leaves = _leaves(rng)
    t, j = tinf._RamTier(), jinf._RamTier()
    for name, a in leaves.items():
        t.put(name, torch.from_numpy(a.copy()))
        j.put(name, a)
    for name, a in leaves.items():
        got = t.get_submit(name, a.shape, a.dtype)
        np.testing.assert_array_equal(got.numpy(),
                                      j.get_submit(name, a.shape, a.dtype))
        assert t.read_sync(name, a.shape, a.dtype) is got
    t.fence_reads()
    assert t.reads_pending() == 0


def test_nvme_tier_writes_jax_bytes_and_reads_them_back(tmp_path):
    """Same names, same arrays: the port's files hold the JAX tier's
    bytes; each tier reads the other's files back exactly, through the
    alternating read slots and through ``read_sync``."""
    rng = np.random.default_rng(2)
    leaves = _leaves(rng)
    t = tinf._NvmeTier(str(tmp_path / "port"))
    j = jinf._NvmeTier(str(tmp_path / "jax"))
    assert t.rpools[0].native and not j.rpools[0].native
    for name, a in leaves.items():
        t.put(name, a)
        j.put(name, a)
    _bounded(t.fence_all)
    _bounded(j.fence_all)
    for name in leaves:
        assert (tmp_path / "port" / f"{name}.bin").read_bytes() == \
            (tmp_path / "jax" / f"{name}.bin").read_bytes()
    # double-buffered reads over both slots, into given and fresh buffers
    t2 = tinf._NvmeTier(str(tmp_path / "jax"))
    for i, (name, a) in enumerate(leaves.items()):
        out = np.empty_like(a) if i % 2 else None
        buf = t2.get_submit(name, a.shape, a.dtype, out=out)
        _bounded(t2.fence_reads)
        t2.next_read_slot()
        np.testing.assert_array_equal(buf, a)
        assert out is None or buf is out
        np.testing.assert_array_equal(t2.read_sync(name, a.shape, a.dtype),
                                      a)
    # torch dtypes: a bf16 leaf round-trips as a tensor
    b = torch.randn(7, 3).to(torch.bfloat16)
    t.put("b", b)
    _bounded(t.fence_writes)
    got = t.get_submit("b", (7, 3), torch.bfloat16)
    _bounded(t.fence_reads)
    assert torch.equal(got, b)
    with pytest.raises(IOError):
        t.read_sync("missing", (2,), np.float32)


def test_pinned_buffer_views():
    pb = tinf.PinnedBuffer(1000)
    v = pb.view(256, (3, 5), torch.float32)
    v.fill_(2.0)
    assert pb.tensor[256:256 + 60].view(torch.float32).sum() == 30.0
    assert not pb._registered      # no CUDA here: plain host memory


def test_infinity_engine_waits_for_zero_offload():
    # the engine is ported; its several-process path and the collective
    # digest still wait for ROADMAP A9's distributed part
    from deepspeed_tpu_torch.config import Config

    with pytest.raises(NotImplementedError, match="A9"):
        tinf.InfinityEngine(None, {}, None, param_specs={})
    eng = tinf.InfinityEngine(
        lambda p, b: p["w"].float().square().sum(), {"w": torch.ones(4)},
        Config.from_dict({"zero_optimization": {"offload_optimizer": {
            "device": "cpu", "scheduled": True}}}), device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        eng.comms_digest({})
