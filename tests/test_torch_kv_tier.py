"""The KV tier of the port against the JAX package: the int8 codec and the
entry encodings (equal buffers and checksums), the host pool (dense round
trip bit-exact, quantised round trip within ``KV_TIER_QUANT_RTOL``,
prequantised entries interchangeable with host-quantised ones, a crc
mismatch raising ``ChecksumError``, the overflow dropping the oldest entry,
pins surviving it), and the serving engine with ``prefix_cache`` +
``kv_tier`` on llama-tiny in f32.

Engines with a dense tier (``quantize_cold`` on or off) must give greedy
tokens IDENTICAL to the JAX engine's, with pages demoted and promoted.  The
JAX engine cannot be the oracle of ``quantized_resident``: its prefill and
chunk views drop the scale planes (``inference/serving.py:1828``,
``:2406``), so it writes K/V truncated to int8 with scale 1.0 there.  That
mode is held instead to JAX's ``forward_paged`` over an int8-resident cache
(logits at 1e-5) through prefill, chunk and
decode, and, end to end, to its own kernel arm (greedy tokens identical)."""

import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.config import KVTierConfig as JKVTierConfig
from deepspeed_tpu.inference import kernels as jk
from deepspeed_tpu.inference import kv_tier as jkv
from deepspeed_tpu.inference.serving import llama_serving_engine as jax_engine
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu_torch.config import KVTierConfig
from deepspeed_tpu_torch.faults import ChecksumError
from deepspeed_tpu_torch.inference import kernels as tk
from deepspeed_tpu_torch.inference import kv_tier as tkv
from deepspeed_tpu_torch.inference.serving import llama_serving_engine
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.weights import from_jax_params
from test_torch_aio import bounded

torch.set_num_threads(1)

PAGE_SHAPE = (2, 2, 8, 16)          # (L, KV, ps, Dh)


def rand_page(seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(PAGE_SHAPE)).astype(np.float32)


def _pools(**kw):
    kw.setdefault("enabled", True)
    return (tkv.KVTierPool(KVTierConfig.coerce(dict(kw)), PAGE_SHAPE,
                           torch.float32),
            jkv.KVTierPool(JKVTierConfig.coerce(dict(kw)), PAGE_SHAPE,
                           np.float32))


# ------------------------------------------------------------ int8 codec
def test_codec_bit_equal_to_jax_with_bound():
    x = rand_page(seed=1)
    x[0, 0, 3] = 0.0
    codes, scale = tkv.quantize_page(x)
    jc, js = jkv.quantize_page(x)
    np.testing.assert_array_equal(codes, jc)
    np.testing.assert_array_equal(scale, js)
    dq = tkv.dequantize_page(codes, scale, torch.float32)
    np.testing.assert_array_equal(dq, jkv.dequantize_page(jc, js, np.float32))
    amax = np.abs(x).max(axis=-1, keepdims=True)
    assert np.all(np.abs(dq - x) <= amax * tkv.KV_TIER_QUANT_RTOL + 1e-7)
    assert np.all(dq[0, 0, 3] == 0.0)
    # the device codec (the int8-resident writers) is the same function
    dc, ds = tk.quantize_kv_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(dc.numpy(), codes)
    np.testing.assert_array_equal(ds.numpy(), scale)


def test_bf16_pages_travel_as_raw_bits():
    x = torch.from_numpy(rand_page(seed=2)).to(torch.bfloat16)
    host = tkv.to_host(x)
    assert host.dtype == np.int16
    assert torch.equal(tkv.from_host(host, torch.bfloat16), x)
    e = tkv.encode_entry(b"k" * 16, host, host, quantize=False,
                         page_dtype=torch.bfloat16)
    assert e.dtype == "bfloat16" and e.nbytes == 2 * x.numel() * 2
    # quantising a bf16 page reads its values, not its bits
    q = tkv.encode_entry(b"k" * 16, host, host, quantize=True,
                         page_dtype=torch.bfloat16)
    np.testing.assert_array_equal(q.data[0],
                                  tkv.quantize_page(x.float().numpy())[0])
    back = tkv.dequantize_page(q.data[0], q.data[1], torch.bfloat16)
    np.testing.assert_array_equal(
        back, tkv.to_host(torch.from_numpy(jkv.dequantize_page(
            q.data[0], q.data[1], np.float32)).to(torch.bfloat16)))


@pytest.mark.parametrize("quantize", [False, True])
def test_entries_match_jax(quantize):
    k, v = rand_page(3), rand_page(4)
    key = bytes(range(16))
    got = tkv.encode_entry(key, k, v, quantize=quantize,
                           page_dtype=torch.float32, tick=5)
    want = jkv.encode_entry(key, k, v, quantize=quantize,
                            page_dtype=np.float32, tick=5)
    for f in ("key", "location", "quantized", "dtype", "buffers", "nbytes",
              "tick", "checksums"):
        assert getattr(got, f) == getattr(want, f), f
    for a, b in zip(got.data, want.data):
        np.testing.assert_array_equal(a, b)


def test_prequantized_entry_interchangeable_with_host_quantised():
    k, v = rand_page(5), rand_page(6)
    key = b"\x01" * 16
    host = tkv.encode_entry(key, k, v, quantize=True,
                            page_dtype=torch.float32)
    pre = tkv.encode_prequantized_entry(key, *tkv.quantize_page(k),
                                        *tkv.quantize_page(v),
                                        page_dtype=torch.float32)
    jpre = jkv.encode_prequantized_entry(key, *jkv.quantize_page(k),
                                         *jkv.quantize_page(v),
                                         page_dtype=np.float32)
    for e in (pre, jpre):
        assert (e.buffers, e.checksums, e.nbytes, e.quantized) == \
            (host.buffers, host.checksums, host.nbytes, host.quantized)


# ------------------------------------------------------------ host pool
def _round_trip(pool, key):
    names, shapes, dtypes = pool.entry_meta(key)
    return [pool.get_submit(n, s, d) for n, s, d in zip(names, shapes,
                                                         dtypes)]


def test_dense_round_trip_bit_exact():
    pool, jpool = _pools()
    k, v = rand_page(7), rand_page(8)
    for p in (pool, jpool):
        assert p.demote(b"a" * 16, k, v) == "host"
    bufs = _round_trip(pool, b"a" * 16)
    got = pool.decode(b"a" * 16, bufs)
    np.testing.assert_array_equal(got[0], k)
    np.testing.assert_array_equal(got[1], v)
    want = jpool.decode(b"a" * 16, _round_trip(jpool, b"a" * 16))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert pool.host_bytes == jpool.host_bytes == 2 * k.nbytes


def test_quantised_round_trip_within_rtol():
    pool, jpool = _pools(quantize_cold=True)
    k, v = rand_page(9), rand_page(10)
    for p in (pool, jpool):
        p.demote(b"q" * 16, k, v)
    got = pool.decode(b"q" * 16, _round_trip(pool, b"q" * 16))
    want = jpool.decode(b"q" * 16, _round_trip(jpool, b"q" * 16))
    for x, g, w in zip((k, v), got, want):
        np.testing.assert_array_equal(g, w)
        amax = np.abs(x).max(axis=-1, keepdims=True)
        assert np.all(np.abs(g - x) <= amax * tkv.KV_TIER_QUANT_RTOL + 1e-7)
    raw = pool.decode_quantized(b"q" * 16, _round_trip(pool, b"q" * 16))
    np.testing.assert_array_equal(raw[0], tkv.quantize_page(k)[0])
    assert pool.demote_prequantized(b"p" * 16, *raw) == "host"
    np.testing.assert_array_equal(
        pool.decode(b"p" * 16, _round_trip(pool, b"p" * 16))[1], got[1])
    dense, _ = _pools()
    dense.demote(b"d" * 16, k, v)
    with pytest.raises(ValueError, match="quantize_cold"):
        dense.demote_prequantized(b"p" * 16, *raw)
    with pytest.raises(ValueError, match="dense entry"):
        dense.decode_quantized(b"d" * 16, _round_trip(dense, b"d" * 16))


@pytest.mark.parametrize("quantize", [False, True])
def test_crc_mismatch_raises_checksum_error(quantize):
    pool, _ = _pools(quantize_cold=quantize)
    pool.demote(b"c" * 16, rand_page(11), rand_page(12))
    bufs = _round_trip(pool, b"c" * 16)
    bufs[0].view(np.uint8).reshape(-1)[0] ^= 0xFF
    with pytest.raises(ChecksumError, match="checksum"):
        pool.decode(b"c" * 16, bufs)
    if quantize:
        with pytest.raises(ChecksumError):
            pool.decode_quantized(b"c" * 16, bufs)


def test_host_overflow_drops_the_oldest_and_pins_survive():
    nbytes = 2 * rand_page().nbytes
    pool, jpool = _pools(host_pool_bytes=3 * nbytes)
    keys = [bytes([i]) * 16 for i in range(6)]
    for p in (pool, jpool):
        for i in range(3):
            p.demote(keys[i], rand_page(i), rand_page(i + 20))
        p.touch(keys[0])                 # 1 is now the oldest
        p.pin([keys[1]])
        p.pin([keys[1]])                 # refcounted
        p.demote(keys[3], rand_page(3), rand_page(23))   # drops 2
        p.unpin([keys[1]])
        p.demote(keys[4], rand_page(4), rand_page(24))   # drops 0
    assert sorted(pool.entries) == sorted(jpool.entries) == \
        sorted([keys[1], keys[3], keys[4]])
    assert pool.dropped_pages == jpool.dropped_pages == 2
    assert pool.host_bytes == jpool.host_bytes == 3 * nbytes
    pool.unpin([keys[1]])
    pool.demote(keys[5], rand_page(5), rand_page(25))
    assert keys[1] not in pool.entries   # unpinned: the oldest again
    # an entry bigger than the whole pool drops; a re-demote only touches
    small, _ = _pools(host_pool_bytes=nbytes - 1)
    assert small.demote(keys[0], rand_page(), rand_page()) is None
    assert small.dropped_pages == 1 and not small.entries
    assert pool.demote(keys[5], rand_page(9), rand_page(9)) == "host"
    assert pool.occupancy()["host_pages"] == 3


def test_disable_and_discard():
    pool, _ = _pools()
    pool.demote(b"x" * 16, rand_page(), rand_page())
    assert pool.has(b"x" * 16)
    pool.disable("test")
    assert not pool.has(b"x" * 16)
    assert pool.demote(b"y" * 16, rand_page(), rand_page()) is None
    pool.discard(b"x" * 16)
    assert not pool.entries and pool.host_bytes == 0


def test_page_reader_streams_groups_through_the_host_view():
    from deepspeed_tpu_torch.param_stream import TierPageReader

    pool, _ = _pools(quantize_cold=True)
    keys = [bytes([i]) * 16 for i in range(5)]
    for i, key in enumerate(keys):
        pool.demote(key, rand_page(i), rand_page(i + 9))
    seen = []
    reader = TierPageReader(pool.host_view(), keys,
                            to_device=lambda bufs, g: seen.append(
                                (g, len(bufs))), group_pages=2)
    assert reader.n_groups == 3
    primed = reader.presubmit(0)
    assert list(reader.sweep(range(reader.n_groups), primed=primed)) == \
        [(0, None), (1, None), (2, None)]
    assert seen == [(0, 8), (1, 8), (2, 4)] and reader.hits == 3


@bounded
def test_nvme_dir_raises_not_implemented(tmp_path):
    """The NVMe rung is ported: ``nvme_dir`` builds the aio channel and
    the host pool's overflow spills there instead of dropping."""
    pool = tkv.KVTierPool(KVTierConfig.coerce({
        "nvme_dir": str(tmp_path), "host_pool_bytes": 4096}),
        PAGE_SHAPE, torch.float32)
    assert pool.uses_aio
    rng = np.random.default_rng(0)
    for i in range(3):
        k, v = (rng.standard_normal(PAGE_SHAPE).astype(np.float32)
                for _ in range(2))
        pool.demote(bytes([i]) * 32, k, v)
    assert [pool.location(bytes([i]) * 32) for i in range(3)] == \
        ["nvme", "nvme", "host"]
    assert pool.dropped_pages == 0 and pool.spilled_pages == 2


# ------------------------------------- model: int8-resident forward_paged
def test_int8_resident_forward_matches_jax():
    """Prefill, a continuation chunk and decode steps over int8-resident
    caches: logits at 1e-5; scales at 1e-5 and codes within one step (the
    two frameworks' f32 products round K and V differently in the last
    bit before the bit-equal codec sees them)."""
    jcfg = jl.LlamaConfig.tiny()
    jp = jl.init_params(jax.random.PRNGKey(1), jcfg)
    tp = from_jax_params(jax.device_get(jp), device="cpu")
    tcfg = tl.LlamaConfig.tiny()
    L, KV, hd = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    P, ps, B, mp = 12, 4, 2, 5
    shape, sshape = (L, KV, P, ps, hd), (L, KV, P, ps, 1)
    table = np.array([[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]], np.int32)
    jc = jk.PagedKVCache(
        k=jnp.zeros(shape, jnp.int8), v=jnp.zeros(shape, jnp.int8),
        table=jnp.asarray(table), seq_lens=jnp.zeros((B,), jnp.int32),
        page_size=ps, k_scale=jnp.ones(sshape, jnp.float32),
        v_scale=jnp.ones(sshape, jnp.float32))
    tc = tk.PagedKVCache(
        k=torch.zeros(shape, dtype=torch.int8),
        v=torch.zeros(shape, dtype=torch.int8),
        table=torch.from_numpy(table), seq_lens=torch.zeros(
            (B,), dtype=torch.int32), page_size=ps,
        k_scale=torch.ones(sshape), v_scale=torch.ones(sshape))
    rng = np.random.default_rng(0)
    steps = [(rng.integers(1, 256, (B, 6)), False),    # prefill
             (rng.integers(1, 256, (B, 5)), True),     # chunk
             (rng.integers(1, 256, (B, 1)), False),    # decode
             (rng.integers(1, 256, (B, 1)), False)]
    for kernel in ("xla", "pallas_v2"):
        jcache, tcache = jc, dataclasses.replace(
            tc, k=tc.k.clone(), v=tc.v.clone(), k_scale=tc.k_scale.clone(),
            v_scale=tc.v_scale.clone())
        for toks, cont in steps:
            toks = toks.astype(np.int32)
            jl_, jcache = jl.forward_paged(
                jp, jnp.asarray(toks), jcfg, jcache, continuation=cont,
                interpret=True, paged_kernel=kernel)
            tl_, tcache = tl.forward_paged(
                tp, torch.from_numpy(toks), tcfg, tcache,
                continuation=cont, paged_kernel=kernel)
            np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_),
                                       rtol=1e-5, atol=1e-5)
            for name in ("k_scale", "v_scale"):
                np.testing.assert_allclose(
                    getattr(tcache, name).numpy(),
                    np.asarray(getattr(jcache, name)), rtol=1e-5,
                    err_msg=name)
            for name in ("k", "v"):
                diff = np.abs(getattr(tcache, name).numpy().astype(int)
                              - np.asarray(getattr(jcache, name)).astype(int))
                assert diff.max() <= 1 and diff.mean() < 1e-3, name


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


def _engine(model, side, **kw):
    cfg, tcfg, jp, tp = model
    opts = dict(BASE, **kw)
    if side == "jax":
        return jax_engine(jp, cfg, cache_dtype=jnp.float32, **opts)
    return llama_serving_engine(tp, tcfg, cache_dtype=torch.float32,
                                device="cpu", **opts)


def _serve(engines, waves, between=None, new_tokens=8):
    """Serve each wave to completion on every engine (``between(engine)``
    runs after the first); returns each engine's outputs and asserts
    ``check_leaks() == []`` after every wave."""
    outs = [{} for _ in engines]
    for i, wave in enumerate(waves):
        if i and between is not None:
            for e in engines:
                between(e)
        for e, out in zip(engines, outs):
            for rid, p in wave.items():
                e.submit(rid, p, max_new_tokens=new_tokens)
            out.update(e.run())
            assert e.check_leaks() == []
    return outs


TIER = {"demote_watermark": 0.0}


@pytest.mark.parametrize("mode", [
    "dense", "quantize_cold", "prefill_chunk", "decode_chunk",
    "small_pool"])
def test_kv_tier_tokens_identical_to_jax(model, mode):
    kw = {"dense": {"kv_tier": TIER},
          "quantize_cold": {"kv_tier": dict(TIER, quantize_cold=True)},
          "prefill_chunk": {"kv_tier": TIER, "prefill_chunk": 8},
          "decode_chunk": {"kv_tier": TIER, "decode_chunk": 3},
          # no watermark: demotion only under allocation pressure (the
          # shared prefix stays warm, so nothing comes back)
          "small_pool": {"kv_tier": {}, "num_pages": 10}}[mode]
    je = _engine(model, "jax", prefix_cache={}, **kw)
    te = _engine(model, "torch", prefix_cache={}, **kw)
    want, got = _serve([je, te], _waves())
    assert got == want
    ta, ja = te.allocator, je.allocator
    assert ta.demoted > 0 and (ta.promoted > 0 or mode == "small_pool")
    assert (ta.demoted, ta.promoted, ta.published, ta.evicted) == \
        (ja.demoted, ja.promoted, ja.published, ja.evicted)
    assert te._kv_pool.host_bytes == je._kv_pool.host_bytes


def _corrupt_all(engine):
    for e in engine._kv_pool.entries.values():
        e.data[0].view(np.uint8).reshape(-1)[0] ^= 0xFF


@pytest.mark.parametrize("quantize", [False, True])
def test_corrupt_host_entry_falls_back_to_reprefill_like_jax(model,
                                                             quantize):
    kvt = dict(TIER, quantize_cold=quantize)
    je = _engine(model, "jax", prefix_cache={}, kv_tier=kvt)
    te = _engine(model, "torch", prefix_cache={}, kv_tier=kvt)
    want, got = _serve([je, te], _waves(), between=_corrupt_all)
    assert got == want
    assert te.kv_tier_checksum_failures > 0
    assert te.kv_tier_fallback_events == je._n_kvt_fallbacks
    assert te.kv_tier_checksum_failures == je._n_kvt_checksum
    # a clean oracle: the same traffic with nothing corrupted
    clean = _engine(model, "torch", prefix_cache={}, kv_tier=kvt)
    assert _serve([clean], _waves())[0] == got


QRES = dict(TIER, quantize_cold=True, quantized_resident=True)


@pytest.mark.parametrize("chunk", [0, 8])
def test_quantized_resident_kernel_arm_matches_plain_arm(model, chunk):
    arms = [_engine(model, "torch", prefix_cache={}, kv_tier=QRES,
                    prefill_chunk=chunk,
                    kernels={"paged_attention": pk})
            for pk in ("pallas_v2", "xla")]
    outs = _serve(arms, _waves())
    assert outs[0] == outs[1] and len(outs[0]) == 8
    for e in arms:
        assert e.cache.k.dtype == torch.int8 and e.cache.k_scale is not None
        assert e.allocator.demoted > 0 and e.allocator.promoted > 0
        assert e.kv_tier_quant_resident_promotes > 0
        assert e.prefix_cache_hits > 0


def test_quantized_resident_demote_promote_is_lossless(model):
    """Promoted int8 pages are the demoted ones, code for code."""
    te = _engine(model, "torch", prefix_cache={}, kv_tier=QRES)
    waves = _waves()
    _serve([te], waves[:1])
    te.step()                            # the watermark sweep demotes
    held = {k: [b.copy() for b in e.data]
            for k, e in te._kv_pool.entries.items()}
    assert held and not te.allocator.pool
    _serve([te], waves[1:])
    promoted = 0
    for key, page in te.allocator.index.items():
        if key in held:
            got = te._fetch_pages_host([page])
            for g, h in zip(got, held[key]):
                np.testing.assert_array_equal(g[:, :, 0], h)
            promoted += 1
    assert promoted > 0


@pytest.mark.parametrize("kvt", [TIER, QRES])
def test_dropped_tiered_engine_frees_without_the_cycle_collector(model,
                                                                   kvt):
    """No reference cycle keeps a dropped engine (and so its weights and
    KV pool) alive: on the card that memory must come back at ``del``."""
    te = _engine(model, "torch", prefix_cache={}, kv_tier=kvt)
    # demotes through the allocator's hook, promotes through a reader
    _serve([te], _waves(), between=lambda e: e.step())
    assert te.allocator.demoted > 0 and te.allocator.promoted > 0
    gone = weakref.ref(te)
    gc.disable()
    try:
        del te
        assert gone() is None
    finally:
        gc.enable()


def test_engine_rejects_what_the_slice_does_not_take(model, tmp_path):
    with pytest.raises(ValueError, match="prefix_cache"):
        _engine(model, "torch", kv_tier={})
    with pytest.raises(ValueError, match="pallas_v1"):
        _engine(model, "torch", prefix_cache={}, kv_tier=QRES,
                kernels={"paged_attention": "pallas_v1"})
    # the NVMe rung builds (it is ported; test_kv_nvme_* drive it)
    assert _engine(model, "torch", prefix_cache={}, kv_tier={
        "nvme_dir": str(tmp_path)})._kv_pool.uses_aio
    # the faults block is ported: it builds and installs its plan for the
    # engine's lifetime
    from deepspeed_tpu_torch import faults

    eng = _engine(model, "torch", prefix_cache={}, kv_tier={}, faults={})
    try:
        assert faults.active_plan() is eng._fault_plan is not None
    finally:
        eng.shutdown()
    assert faults.active_plan() is None


# ------------------------------------------------------------ NVMe rung
@pytest.fixture
def jax_python_aio(monkeypatch):
    """The JAX pool's NVMe rung on its pure-Python aio arm (the
    reference's native pool is not driven here)."""
    import deepspeed_tpu.io.aio as jaio

    monkeypatch.setattr(jaio, "_ensure_lib", lambda: None)


@pytest.mark.parametrize("quantize", [False, True])
@bounded
def test_kv_nvme_cascade_matches_jax(tmp_path, jax_python_aio, quantize):
    """The same demote sequence through both pools under a host pool of
    three pages and an NVMe cap of four: every key's location, the byte
    totals, the spill / drop counts, the buffers' crc32 and the spilled
    files' bytes are the JAX pool's; promotion reads (the alternating aio
    slots) and the synchronous rung return the demoted payload."""
    page = int(np.prod(PAGE_SHAPE)) * 4
    per = 2 * page if not quantize else None
    t, j = _pools(quantize_cold=quantize, host_pool_bytes=3 * (per or 1),
                  nvme_pool_bytes=4 * (per or 1),
                  nvme_dir=str(tmp_path / "port"))
    if quantize:
        # size the pools to the quantised entry's bytes
        k, v = rand_page(0), rand_page(1)
        n = jkv.encode_entry(b"x" * 16, k, v, quantize=True,
                             page_dtype=np.float32).nbytes
        t, j = _pools(quantize_cold=True, host_pool_bytes=3 * n,
                      nvme_pool_bytes=4 * n,
                      nvme_dir=str(tmp_path / "port"))
    j = jkv.KVTierPool(JKVTierConfig.coerce(dict(
        enabled=True, quantize_cold=quantize,
        host_pool_bytes=t.cfg.host_pool_bytes,
        nvme_pool_bytes=t.cfg.nvme_pool_bytes,
        nvme_dir=str(tmp_path / "jax"))), PAGE_SHAPE, np.float32)
    keys = [bytes([i]) * 16 for i in range(9)]
    pages = {}
    for i, key in enumerate(keys):
        pages[key] = (rand_page(10 + i), rand_page(30 + i))
        assert t.demote(key, *pages[key]) == j.demote(key, *pages[key])
        if i == 4:        # a touch reorders the cascade on both
            assert t.touch(keys[0]) == j.touch(keys[0])
    assert t.uses_aio and t.spilled_pages > 0 and t.dropped_pages > 0
    for key in keys:
        assert t.location(key) == j.location(key), key
    occ = t.occupancy()
    for f, v in j.occupancy().items():
        assert occ[f] == v, f
    for key in keys:
        if t.location(key) is None:
            continue
        te, je = t.entries[key], j.entries[key]
        assert te.checksums == je.checksums and te.nbytes == je.nbytes
        if te.location == "nvme":
            for name in te.names:
                assert (tmp_path / "port" / f"{name}.bin").read_bytes() == \
                    (tmp_path / "jax" / f"{name}.bin").read_bytes()
    # promotion reads: NVMe entries through the aio slots, host entries
    # zero-copy, each decoded (checksum first) to the demoted page
    for key in keys:
        if t.location(key) is None:
            continue
        names, shapes, dtypes = t.entry_meta(key)
        bufs = [t.get_submit(n, s, d) for n, s, d in zip(names, shapes,
                                                         dtypes)]
        t.fence_reads()
        t.next_read_slot()
        k, v = t.decode(key, bufs)
        jk, jv = j.decode(key, [j.read_sync(n, s, d) for n, s, d in
                                zip(names, shapes, dtypes)])
        np.testing.assert_array_equal(k, jk)
        np.testing.assert_array_equal(v, jv)
        sync = [t.read_sync(n, s, d) for n, s, d in zip(names, shapes,
                                                        dtypes)]
        for a, b in zip(sync, bufs):
            np.testing.assert_array_equal(a, b)
    # discarding an NVMe entry removes its files
    nv = next(k for k in keys if t.location(k) == "nvme")
    names = t.entries[nv].names
    t.discard(nv)
    assert not any((tmp_path / "port" / f"{n}.bin").exists()
                   for n in names)


@bounded
def test_kv_nvme_pinned_entries_do_not_spill(tmp_path):
    page = 2 * int(np.prod(PAGE_SHAPE)) * 4
    t = tkv.KVTierPool(KVTierConfig.coerce(dict(
        host_pool_bytes=2 * page, nvme_dir=str(tmp_path))), PAGE_SHAPE,
        torch.float32)
    a, b, c = (bytes([i]) * 16 for i in range(3))
    t.demote(a, rand_page(1), rand_page(2))
    t.demote(b, rand_page(3), rand_page(4))
    t.pin([a])
    t.demote(c, rand_page(5), rand_page(6))
    assert (t.location(a), t.location(b), t.location(c)) == \
        ("host", "nvme", "host")
    with pytest.raises(RuntimeError, match="channel-free"):
        t.host_view().get_submit(t.entries[b].names[0], (1,), "float32")


def test_kv_nvme_priority_defers_to_higher_members(tmp_path):
    from deepspeed_tpu_torch.io.aio import AioPriorityGroup

    t = tkv.KVTierPool(KVTierConfig.coerce({"nvme_dir": str(tmp_path)}),
                       PAGE_SHAPE, torch.float32)
    assert t.may_submit()
    busy = {"n": 0}
    g = AioPriorityGroup()
    g.register(lambda: busy["n"], 1)
    t.set_priority(g, 0)
    assert t.may_submit()
    busy["n"] = 2
    assert not t.may_submit()


@pytest.mark.parametrize("kw", [{}, {"prefill_chunk": 8},
                                {"kv_tier_extra": {"quantize_cold": True}}],
                         ids=["dense", "prefill_chunk", "quantize_cold"])
@bounded
def test_kv_nvme_engine_tokens_identical_to_jax(model, tmp_path,
                                                jax_python_aio, kw):
    """Two waves on one prefix with a host pool too small for wave a's
    pages: they cascade to NVMe and wave b promotes them back through the
    aio channel, one NVMe-backed promotion at a time (the others wait at
    admission).  Tokens equal the JAX engine's and the host-only run's."""
    kw = dict(kw)
    extra = kw.pop("kv_tier_extra", {})
    page = 2 * 2 * 2 * 8 * 16 * 4        # k + v: L, KV, ps, Dh, f32
    tier = dict(TIER, host_pool_bytes=page, **extra)
    host_only = _engine(model, "torch", prefix_cache={},
                        kv_tier=dict(TIER, **extra), **kw)
    je = _engine(model, "jax", prefix_cache={}, kv_tier=dict(
        tier, nvme_dir=str(tmp_path / "jax")), **kw)
    te = _engine(model, "torch", prefix_cache={}, kv_tier=dict(
        tier, nvme_dir=str(tmp_path / "port")), **kw)
    want, got, host = _serve([je, te, host_only], _waves(),
                             between=lambda e: e.step())
    assert got == want == host
    occ = te._kv_pool.occupancy()
    assert occ["spilled_pages"] > 0
    assert te.allocator.promoted > 0
    jc = je.registry.snapshot()["counters"]
    assert te.allocator.promoted == je.allocator.promoted
    # the scheduler loops count admission retries differently; both wait
    assert (te.kv_tier_admit_waits > 0) == (jc["kv_tier_admit_waits"] > 0)
    assert te._promo_channel is None and te.check_leaks() == []


@bounded
def test_kv_nvme_admission_waits_for_the_channel(model, tmp_path):
    """While one promotion owns the NVMe channel, an admission whose span
    needs NVMe bytes waits (counted) instead of re-prefilling it, and goes
    in once the channel frees."""
    page = 2 * 2 * 2 * 8 * 16 * 4
    te = _engine(model, "torch", prefix_cache={}, kv_tier=dict(
        TIER, host_pool_bytes=page, nvme_dir=str(tmp_path)))
    waves = _waves()
    _serve([te], waves[:1])
    te.step()                         # the watermark sweep demotes
    assert te._kv_pool.occupancy()["nvme_pages"] > 0
    b0, b1 = list(waves[1].items())[:2]
    te.submit(*b0, max_new_tokens=4)
    te._admit_one()
    owner = te._promo_channel
    assert owner is not None and te.slots[owner].promo.channel
    te.submit(*b1, max_new_tokens=4)
    waits = te.kv_tier_admit_waits
    assert not te._admit_one()
    assert te.kv_tier_admit_waits == waits + 1
    out = te.run()
    assert {b0[0], b1[0]} <= set(out) and te._promo_channel is None
    assert out[b0[0]][:len(b0[1])] == b0[1]
    assert te.check_leaks() == []
