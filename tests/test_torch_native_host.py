"""The port's host runtime natives (``deepspeed_tpu_torch/io/native.py``
over its own ``csrc/host/hostruntime.cpp``) against the JAX package's: the
buffer pool recycles, survives a double put and reports the same stats;
the native shuffle equals its pure-Python mirror, the JAX mirror and the
JAX index service bit for bit over several (n, seed, epoch); the data
loader takes its epoch order from the service; a missing build reports
``native`` false and keeps both APIs working."""

from pathlib import Path

import numpy as np
import pytest
import torch

from deepspeed_tpu.io import native as jnative
from deepspeed_tpu_torch.data import loader as tloader
from deepspeed_tpu_torch.io import native as tnative

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
CASES = [(1, 0, 0), (2, 3, 1), (37, 0, 0), (100, 3, 2), (64, 12345, 7),
         (1000, 42, 2**33 + 1)]


def test_native_lib_builds_from_the_ports_source():
    assert tnative._ensure_lib() is not None
    assert Path(tnative._SRC) == ROOT / "deepspeed_tpu_torch" / "csrc" / \
        "host" / "hostruntime.cpp"
    assert Path(tnative._LIB).parent == ROOT / "build" / \
        "deepspeed_tpu_torch" / "host"


def test_buffer_pool_recycles_and_matches_jax_stats():
    stats = []
    for mod in (tnative, jnative):
        pool = mod.HostBufferPool()
        a, h = pool.get(1 << 16)
        assert a.nbytes == 1 << 16 and a.dtype == np.uint8
        a[:] = 7
        pool.put(h)
        b, h2 = pool.get(1 << 16)
        assert h2 == h                  # the same buffer, recycled
        stats.append(pool.stats())
        pool.put(h2)
        pool.trim()
        assert pool.stats()["bytes_pooled"] == 0
        pool.close()
    assert stats[0] == stats[1]
    assert stats[0] == {"bytes_pooled": 0, "bytes_live": 1 << 16,
                        "hits": 1, "misses": 1, "native": True}


def test_buffer_pool_double_put_is_safe():
    pool = tnative.HostBufferPool()
    view, h = pool.get(4096)
    t = torch.from_numpy(view)          # a CPU tensor over the same bytes
    t.fill_(3)
    assert int(view.sum()) == 3 * 4096
    del t, view
    pool.put(h)
    pool.put(h)                         # ignored: no crash, no corruption
    s = pool.stats()
    assert s["bytes_live"] == 0 and s["bytes_pooled"] == 4096
    _, h2 = pool.get(4096)
    assert h2 == h and pool.stats()["hits"] == 1
    pool.close()


def test_pool_sizes_page_aligned_and_capped_reuse():
    pool = tnative.HostBufferPool()
    _, h = pool.get(5000)
    assert h % 4096 == 0
    pool.put(h)
    _, big = pool.get(20000)            # > 2x the pooled 8192: a new one
    assert pool.stats()["misses"] == 2 and big != h
    pool.close()


@pytest.mark.parametrize("n,seed,epoch", CASES)
def test_native_shuffle_equals_mirrors_and_jax_service(n, seed, epoch):
    svc = tnative.ShuffleIndexService(n, seed=seed)
    assert svc.native
    got = svc.epoch_order(epoch)
    np.testing.assert_array_equal(got,
                                  tnative._splitmix64_shuffle(n, seed, epoch))
    np.testing.assert_array_equal(got,
                                  jnative._splitmix64_shuffle(n, seed, epoch))
    jsvc = jnative.ShuffleIndexService(n, seed=seed)
    np.testing.assert_array_equal(got, jsvc.epoch_order(epoch))
    np.testing.assert_array_equal(svc.window(epoch, n // 3, 5),
                                  jsvc.window(epoch, n // 3, 5))
    assert sorted(got.tolist()) == list(range(n))
    svc.close()
    jsvc.close()


def test_window_clips_and_unshuffled_service():
    svc = tnative.ShuffleIndexService(10, seed=1)
    assert len(svc.window(0, 8, 5)) == 2
    assert len(svc.window(0, 12, 5)) == 0
    flat = tnative.ShuffleIndexService(10, shuffle=False)
    assert not flat.native
    np.testing.assert_array_equal(flat.window(3, 4, 10), np.arange(4, 10))


@pytest.mark.parametrize("seed,epoch", [(0, 0), (5, 3)])
def test_loader_takes_its_epoch_order_from_the_service(seed, epoch):
    data = [{"x": np.int32(i)} for i in range(23)]
    dl = tloader.DataLoader(data, batch_size=4, seed=seed)
    dl.set_epoch(epoch)
    got = np.concatenate([b["x"] for b in dl])
    want = tnative.ShuffleIndexService(23, seed=seed).epoch_order(epoch)
    np.testing.assert_array_equal(got, want[:20])
    assert isinstance(dl._idx_svc, tnative.ShuffleIndexService)
    assert dl._idx_svc.native


def test_missing_build_reports_not_native(monkeypatch):
    monkeypatch.setattr(tnative, "_ensure_lib", lambda: None)
    pool = tnative.HostBufferPool()
    view, h = pool.get(100)
    assert pool.stats() == {"bytes_pooled": 0, "bytes_live": 100, "hits": 0,
                            "misses": 0, "native": False}
    pool.put(h)
    assert pool.stats()["bytes_live"] == 0
    svc = tnative.ShuffleIndexService(50, seed=9)
    assert not svc.native
    np.testing.assert_array_equal(svc.epoch_order(2),
                                  jnative._splitmix64_shuffle(50, 9, 2))
    dl = tloader.DataLoader([{"x": np.int32(i)} for i in range(8)], 2,
                            seed=9)
    dl._indices()
    assert not dl._idx_svc.native


def test_missing_toolchain_gives_no_library(monkeypatch, tmp_path):
    from deepspeed_tpu_torch.utils import ctypes_build

    monkeypatch.setenv("PATH", str(tmp_path))      # no g++ on the path
    assert ctypes_build.load_or_build(str(tmp_path / "lib.so"),
                                      tnative._SRC) is None
