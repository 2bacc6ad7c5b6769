"""Prefix caching of the port against the JAX package: the chained page keys
(byte-equal), the full ``PageAllocator`` (the same operation sequences give
the same free list, refcounts, warm pool, index, promotion states and
counts), and the serving engine with ``prefix_cache`` on llama-tiny in f32,
whose greedy tokens must be IDENTICAL to the JAX engine's, with
``check_leaks() == []`` on both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import kernels as jk
from deepspeed_tpu.inference import prefix_cache as jpc
from deepspeed_tpu.inference.serving import llama_serving_engine as jax_engine
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu_torch.inference import kernels as tk
from deepspeed_tpu_torch.inference import prefix_cache as tpc
from deepspeed_tpu_torch.inference.serving import llama_serving_engine
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)


# ------------------------------------------------------------ hash chain
@pytest.mark.parametrize("ps", [1, 4, 16])
def test_page_keys_byte_equal_to_jax(ps):
    rng = np.random.default_rng(ps)
    for n in (0, ps - 1, ps, 3 * ps + 2, 70):
        toks = rng.integers(-5, 128256, n).tolist()
        assert tpc.page_keys(toks, ps) == jpc.page_keys(toks, ps)
        keys_t, keys_j = [], []
        for m in range(n // ps + 1):       # incremental growth
            tpc.extend_page_keys(keys_t, toks, m, ps)
            jpc.extend_page_keys(keys_j, toks, m, ps)
            assert keys_t == keys_j
        assert [tpc.key_hex(k) for k in keys_t] == \
            [jpc.key_hex(k) for k in keys_j]
        assert tpc.matchable_pages(n, ps) == jpc.matchable_pages(n, ps)


def test_chain_diverges_on_earlier_tokens():
    a = tpc.page_keys([1, 2, 3, 4, 5, 6, 7, 8], 4)
    c = tpc.page_keys([9, 2, 3, 4, 5, 6, 7, 8], 4)
    assert len(a) == 2 and a[0] != c[0] and a[1] != c[1]


# ------------------------------------------------------------- allocator
class _FakeSpill:
    def __init__(self, keys=()):
        self.keys = set(keys)

    def has(self, k):
        return k in self.keys


def _legacy(a):
    got = a.allocate("s", 3)
    a.release("s")
    return got


def _share_release(a):
    (p,) = a.allocate("s1", 1)
    out = [a.publish(p, b"k")]
    a.share("s2", [p])
    a.release("s1")
    a.release("s2")
    return out


def _lookup(a):
    p0, p1 = a.allocate("s", 2)
    a.publish(p0, b"k0")
    a.publish(p1, b"k1")
    return [a.lookup([b"k0", b"k1", b"k2"]), a.lookup([b"kX", b"k1"])]


def _revive(a):
    (p,) = a.allocate("s1", 1)
    a.publish(p, b"k")
    a.release("s1")
    a.share("s2", [p])
    return [a.lookup([b"k"])]


def _pressure(a):
    for name in ("old", "mid", "new"):
        (p,) = a.allocate(name, 1)
        a.publish(p, name.encode())
        a.release(name)
    a.share("toucher", a.lookup([b"old"]))
    a.release("toucher")
    return [a.allocate("fresh", 2), a.lookup([b"old"]), a.lookup([b"mid"])]


def _cap(a):
    p = a.allocate("s", 2)
    a.publish(p[0], b"k0")
    a.publish(p[1], b"k1")
    a.release("s")
    return p


def _dedup(a):
    p0, p1 = a.allocate("s", 2)
    out = [a.publish(p0, b"k"), a.publish(p1, b"k"), a.publish(p0, b"k2")]
    try:                                 # unowned: raises when caching
        out.append(a.publish(99, b"k3"))
    except ValueError as e:
        out.append(str(e))
    return out + [a.writable(p0), a.writable(p1)]


def _out_of_pages(a):
    (p,) = a.allocate("s1", 1)
    a.publish(p, b"k")
    a.release("s1")
    got = a.allocate("s2", 2)
    with pytest.raises(MemoryError):
        a.allocate("s3", 1)
    return got


def _tiered(a):
    (p0,) = a.allocate("s", 1)
    a.publish(p0, b"k0")
    a.spill = _FakeSpill([b"k1", b"k2"])
    return [a.lookup_tiered([b"k0", b"k1", b"k2", b"k3"]),
            a.lookup_tiered([b"kX", b"k1"])]


def _demote_hook(a):
    captured = []
    a.demote_hook = lambda p, k: captured.append((p, k)) or k != b"y"
    for name in ("x", "y", "z"):
        (p,) = a.allocate(name, 1)
        a.publish(p, name.encode())
        a.release(name)
    a.allocate("fresh", 2)
    return captured


def _promotion(a):
    (p,) = a.allocate("s", 1)
    a.begin_promotion(p, b"k")
    out = [a.available, a.writable(p), a.finish_promotion(p, b"k")]
    a.release("s")
    (q,) = a.allocate("t", 1)
    a.begin_promotion(q, b"q")
    a.release("t")                       # parks, not frees
    out.append(a.available)
    out.append(a.finish_promotion(q, b"q"))   # frees without publish
    (r,) = a.allocate("u", 1)
    a.begin_promotion(r, b"r")
    a.release("u")
    a.cancel_promotion(r)
    with pytest.raises(ValueError, match="unowned"):
        a.begin_promotion(99, b"z")
    return out


def _warm_reclaim(a):
    for name in ("old", "mid", "new"):
        (p,) = a.allocate(name, 1)
        a.publish(p, name.encode())
        a.release(name)
    cands = a.oldest_warm(2)
    a.reclaim_warm([cands[0][0]], demoted=True)
    a.reclaim_warm([cands[1][0]], demoted=False)
    return cands


SCENARIOS = {
    "legacy": (_legacy, 4, 0, "lru"),
    "share_release": (_share_release, 4, 4, "lru"),
    "lookup": (_lookup, 4, 4, "lru"),
    "revive": (_revive, 2, 2, "lru"),
    "lru_pressure": (_pressure, 3, 3, "lru"),
    "fifo_pressure": (_pressure, 3, 3, "fifo"),
    "pool_cap": (_cap, 4, 1, "lru"),
    "dedup": (_dedup, 4, 4, "lru"),
    "dedup_cache_off": (_dedup, 4, 0, "lru"),
    "out_of_pages": (_out_of_pages, 2, 2, "lru"),
    "lookup_tiered": (_tiered, 4, 4, "lru"),
    "demote_hook": (_demote_hook, 3, 3, "lru"),
    "promotion": (_promotion, 4, 4, "lru"),
    "warm_reclaim": (_warm_reclaim, 3, 3, "lru"),
}


def _state(a):
    return (sorted(a.free), a.free, a.owned, a.refs, a.index, a.key_of,
            a.pool, a.promoting, a._parked, a.available, a.evicted,
            a.published, a.demoted, a.promoted)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_page_allocator_matches_jax(name):
    ops, n, cap, eviction = SCENARIOS[name]
    a_t = tk.PageAllocator(n, cache_pages=cap, eviction=eviction)
    a_j = jk.PageAllocator(n, cache_pages=cap, eviction=eviction)
    assert ops(a_t) == ops(a_j)
    assert _state(a_t) == _state(a_j)


def test_allocator_without_cache_is_the_classic_free_list():
    a = tk.PageAllocator(6)
    got = a.allocate("a", 2) + a.allocate("b", 3)
    assert sorted(got) == [0, 1, 2, 3, 4] and a.available == 1
    assert not a.publish(got[0], b"k")
    a.release("a")
    a.release("b")
    assert sorted(a.free) == list(range(6)) and not a.refs and not a.pool
    with pytest.raises(ValueError, match="eviction"):
        tk.PageAllocator(2, eviction="random")


# ---------------------------------------------------------------- engine
BASE = dict(max_batch=3, page_size=8, num_pages=40, max_seq=64,
            prefill_bucket=8)


@pytest.fixture(scope="module")
def model():
    cfg = jl.LlamaConfig.tiny()
    jp = jl.init_params(jax.random.PRNGKey(0), cfg)
    tp = from_jax_params(jax.device_get(jp), device="cpu")
    return cfg, tl.LlamaConfig.tiny(), jp, tp


def _waves(seed=5, n=4):
    """Two waves of prompts sharing a 20-token prefix."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 256, 20).tolist()
    return [{f"{w}{i}": shared + rng.integers(1, 256, int(rng.integers(
        2, 9))).tolist() for i in range(n)} for w in ("a", "b")]


def serve_both(model, waves, new_tokens=8, **kw):
    """Serve each wave to completion on both engines; every wave's outputs
    must be identical and both engines leak-free after each."""
    cfg, tcfg, jp, tp = model
    opts = dict(BASE, **kw)
    je = jax_engine(jp, cfg, cache_dtype=jnp.float32, telemetry={}, **opts)
    te = llama_serving_engine(tp, tcfg, cache_dtype=torch.float32,
                              device="cpu", **opts)
    for wave in waves:
        for rid, p in wave.items():
            je.submit(rid, p, max_new_tokens=new_tokens)
            te.submit(rid, p, max_new_tokens=new_tokens)
        want, got = je.run(), te.run()
        assert got == want
        assert je.check_leaks() == [] and te.check_leaks() == []
    return je, te


@pytest.mark.parametrize("mode", [
    "whole_prompt", "prefill_chunk", "decode_chunk", "fifo_small_pool",
    "cap_2_pages", "preemption"])
def test_prefix_cache_tokens_identical_to_jax(model, mode):
    kw = {"whole_prompt": {},
          "prefill_chunk": {"prefill_chunk": 8},
          "decode_chunk": {"decode_chunk": 3},
          "fifo_small_pool": {"num_pages": 14,
                              "prefix_cache": {"eviction": "fifo"}},
          "cap_2_pages": {"prefix_cache": {"max_cached_pages": 2}},
          "preemption": {"num_pages": 11}}[mode]
    kw.setdefault("prefix_cache", {})
    je, te = serve_both(model, _waves(), new_tokens=16 if mode ==
                        "preemption" else 8, **kw)
    assert te.prefix_cache_hits > 0
    if mode == "preemption":
        assert te.preempted > 0
    for field in ("published", "evicted"):
        assert getattr(te.allocator, field) == getattr(je.allocator, field)
    snap = je.registry.snapshot()["counters"]
    for name in ("prefix_cache_hits", "prefix_cache_misses",
                 "prefix_cache_cached_tokens", "prefix_cache_prompt_tokens"):
        assert getattr(te, name) == snap[name], name


def test_prefix_cache_hit_skips_prefill_compute(model):
    _, te = serve_both(model, _waves(), prefix_cache={})
    # wave b shares 2 full pages of the 20-token prefix with wave a
    assert te.prefix_cache_cached_tokens >= 4 * 16
    assert te.prefix_cache_prompt_tokens == sum(
        len(p) for w in _waves() for p in w.values())
