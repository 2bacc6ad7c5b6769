"""Paged KV of the port against the JAX package: the plain paged attention
versions (the CUDA kernels' twins) against the Pallas kernels in interpret
mode — B5 against v2, B7 against the int8 v2 kernel, B8 against v1 — the
page writers (drop-on-overflow included, dense and int8), the int8 codec
(bit-equal), the page allocator and the kernel policy.  Attention
tolerances are f32: 1e-5; codes, scales and written planes are equal."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import kernels as jk
from deepspeed_tpu.inference import kv_tier as jkv
from deepspeed_tpu_torch.inference import kernels as tk
from deepspeed_tpu_torch.inference.paged_attention_cuda import (
    paged_chunk_attention, paged_chunk_attention_quant,
    paged_chunk_attention_v1, paged_decode_attention,
    paged_decode_attention_quant, paged_decode_attention_v1)

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _pages(KV=2, P=24, ps=4, Dh=16, seed=0):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((KV, P, ps, Dh), dtype=np.float32)
    v = rng.standard_normal((KV, P, ps, Dh), dtype=np.float32)
    return k, v


def _table(B, mp, P, seed=0):
    """Distinct live pages per row; every slot holds SOME valid page id, so
    entries past a row's frontier are stale (another row's page or the
    trash page P-1), as the engine leaves them."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(P - 1)[:B * mp].reshape(B, mp)
    stale = rng.integers(0, P, (B, mp))
    return perm.astype(np.int32), stale.astype(np.int32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("G", [1, 4])
def test_decode_matches_pallas_v2_interpret(G):
    KV, ps, Dh, B, mp = 2, 4, 16, 4, 5
    kp, vp = _pages(KV=KV, ps=ps, Dh=Dh, seed=G)
    live, stale = _table(B, mp, kp.shape[1], seed=G)
    lens = np.array([0, 1, 7, 20], np.int32)    # row 0 is empty
    used = -(-lens // ps)
    table = np.where(np.arange(mp)[None] < used[:, None], live, stale)
    q = np.random.default_rng(G + 9).standard_normal(
        (B, KV * G, Dh), dtype=np.float32)
    want = np.asarray(jk.paged_decode_attention_v2(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lens), pages_per_block=2, interpret=True))
    got = paged_decode_attention(_t(q), _t(kp), _t(vp), _t(table), _t(lens))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[0].any(), "an empty row must give zeros"
    ref = np.asarray(jk.paged_attention_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lens)))
    np.testing.assert_allclose(
        tk.paged_attention_reference(_t(q), _t(kp), _t(vp), _t(table),
                                     _t(lens)).numpy(), ref, **TOL)


@pytest.mark.parametrize("C,G", [(3, 2), (8, 4), (5, 1)])
def test_chunk_matches_pallas_v2_interpret(C, G):
    KV, ps, Dh, B, mp = 2, 4, 16, 3, 6
    kp, vp = _pages(KV=KV, ps=ps, Dh=Dh, seed=C)
    live, stale = _table(B, mp, kp.shape[1], seed=C)
    start = np.array([0, 5, 13], np.int32)
    used = -(-(start + C) // ps)
    table = np.where(np.arange(mp)[None] < used[:, None], live, stale)
    q = np.random.default_rng(C + G).standard_normal(
        (B, C, KV * G, Dh), dtype=np.float32)
    want = np.asarray(jk.paged_chunk_attention_v2(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(start), pages_per_block=2, interpret=True))
    got = paged_chunk_attention(_t(q), _t(kp), _t(vp), _t(table), _t(start))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    ref = np.asarray(jk.paged_chunk_attention_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(start)))
    np.testing.assert_allclose(
        tk.paged_chunk_attention_reference(
            _t(q), _t(kp), _t(vp), _t(table), _t(start)).numpy(), ref, **TOL)


def _write_both(fn_j, fn_t, kp, vp, args_j, args_t):
    kj, vj = fn_j(jnp.asarray(kp), jnp.asarray(vp), *args_j)
    kt, vt = _t(kp.copy()), _t(vp.copy())
    rk, rv = fn_t(kt, vt, *args_t)
    assert rk is kt and rv is vt, "the port writes pages in place"
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_write_token_pages_drops_at_capacity():
    kp, vp = _pages(P=12, ps=4)
    table = np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8]], np.int32)
    lens = np.array([0, 5, 12], np.int32)       # row 2 is at capacity
    rng = np.random.default_rng(3)
    nk = rng.standard_normal((3, 2, 16), dtype=np.float32)
    nv = rng.standard_normal((3, 2, 16), dtype=np.float32)
    _write_both(jk.write_token_pages, tk.write_token_pages, kp, vp,
                (jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(table),
                 jnp.asarray(lens), 4),
                (_t(nk), _t(nv), _t(table), _t(lens), 4))


def test_write_prompt_pages_pads_last_page():
    kp, vp = _pages(P=12, ps=4)
    table = np.array([[5, 2, 9], [0, 7, 3]], np.int32)
    rng = np.random.default_rng(4)
    nk = rng.standard_normal((2, 7, 2, 16), dtype=np.float32)
    nv = rng.standard_normal((2, 7, 2, 16), dtype=np.float32)
    _write_both(jk.write_prompt_pages, tk.write_prompt_pages, kp, vp,
                (jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(table), 4),
                (_t(nk), _t(nv), _t(table), 4))


@pytest.mark.parametrize("start", [[0, 3, 9], [2, 8, 12], [10, 11, 30]])
def test_write_chunk_pages_drops_past_capacity(start):
    # capacity 12 per row; C = 6 chunks straddle it, and a chunk longer
    # than a page wraps past it onto offsets a live position also writes
    kp, vp = _pages(P=12, ps=4)
    table = np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8]], np.int32)
    st = np.array(start, np.int32)
    rng = np.random.default_rng(sum(start))
    nk = rng.standard_normal((3, 6, 2, 16), dtype=np.float32)
    nv = rng.standard_normal((3, 6, 2, 16), dtype=np.float32)
    _write_both(jk.write_chunk_pages, tk.write_chunk_pages, kp, vp,
                (jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(table),
                 jnp.asarray(st), 4),
                (_t(nk), _t(nv), _t(table), _t(st), 4))


def test_page_allocator_refcounts_and_leaks():
    al = tk.PageAllocator(6)
    a = al.allocate("a", 2)
    b = al.allocate("b", 3)
    assert sorted(a + b) == [0, 1, 2, 3, 4]
    assert al.available == 1
    assert all(al.refs[p] == 1 for p in a + b)
    with pytest.raises(MemoryError):
        al.allocate("c", 2)
    al.release("a")
    assert al.available == 3 and "a" not in al.owned
    assert not any(p in al.refs for p in a)
    al.release("a")                             # idempotent
    al.release("b")
    assert sorted(al.free) == list(range(6)) and al.refs == {}
    # same order as the reference allocator: the lowest ids go first
    ref = jk.PageAllocator(6)
    assert ref.allocate("x", 4) == tk.PageAllocator(6).allocate("x", 4)


def test_kernel_policy_resolution():
    cpu = tk.resolve_serving_kernels(None, device="cpu")
    assert (cpu.paged_attention, cpu.fused_sampling) == ("xla", "off")
    forced = tk.resolve_serving_kernels(
        {"paged_attention": "pallas_v2", "fused_sampling": "on"},
        device="cpu")
    assert (forced.paged_attention, forced.fused_sampling) == (
        "pallas_v2", "on")
    assert tk.resolve_serving_kernels(forced) is forced
    v1 = tk.resolve_serving_kernels({"paged_attention": "pallas_v1"},
                                    device="cpu")
    assert v1.paged_attention == "pallas_v1"
    with pytest.raises(ValueError):
        tk.resolve_serving_kernels({"fused_sampling": "maybe"}, device="cpu")


# ----------------------------------------------------- int8 codec (B7 path)
def _quant_pages(KV=2, P=24, ps=4, Dh=16, seed=0):
    """int8 pages made by the port's codec from f32 pages (some zero rows)."""
    k, v = _pages(KV=KV, P=P, ps=ps, Dh=Dh, seed=seed)
    k[:, ::5, 1] = 0.0
    kq, ks = tk.quantize_kv_rows(_t(k))
    vq, vs = tk.quantize_kv_rows(_t(v))
    return kq.numpy(), ks.numpy(), vq.numpy(), vs.numpy()


def _codec_input():
    rng = np.random.default_rng(7)
    x = (3.0 * rng.standard_normal((4, 3, 16))).astype(np.float32)
    x[0, 0] = 0.0                               # a zero row: scale 1.0
    # exact .5 ties of x / scale: amax 127 gives scale 1.0 exactly
    x[1, 0] = 0.0
    x[1, 0, 0] = 127.0
    x[1, 0, 1:8] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    return x


def test_quantize_kv_rows_bit_equal_to_jax_and_tier_codec():
    x = _codec_input()
    codes, scale = tk.quantize_kv_rows(_t(x))
    jc, js = jk.quantize_kv_rows(jnp.asarray(x))
    hc, hs = jkv.quantize_page(x)
    for c, sc in ((np.asarray(jc), np.asarray(js)), (hc, hs)):
        np.testing.assert_array_equal(codes.numpy(), c)
        np.testing.assert_array_equal(scale.numpy(), sc)
    assert scale[0, 0, 0] == 1.0 and not codes[0, 0].any()
    # round half to even on the planted ties
    assert codes[1, 0, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]
    np.testing.assert_array_equal(
        tk.dequantize_pages(codes, scale, torch.float32).numpy(),
        np.asarray(jk.dequantize_pages(jc, js, jnp.float32)))


def _write_quant_both(fn_j, fn_t, args_j, args_t, seed=0):
    kq, ks, vq, vs = _quant_pages(P=12, seed=seed)
    want = fn_j(*(jnp.asarray(a) for a in (kq, ks, vq, vs)), *args_j)
    planes = [_t(a.copy()) for a in (kq, ks, vq, vs)]
    got = fn_t(*planes, *args_t)
    assert all(g is p for g, p in zip(got, planes)), "written in place"
    for g, w in zip(planes, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_write_token_pages_quant_matches_jax():
    table = np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8]], np.int32)
    lens = np.array([0, 5, 12], np.int32)       # row 2 is at capacity
    rng = np.random.default_rng(3)
    nk = rng.standard_normal((3, 2, 16), dtype=np.float32)
    nv = rng.standard_normal((3, 2, 16), dtype=np.float32)
    _write_quant_both(
        jk.write_token_pages_quant, tk.write_token_pages_quant,
        (jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(table),
         jnp.asarray(lens), 4), (_t(nk), _t(nv), _t(table), _t(lens), 4))


def test_write_prompt_pages_quant_pads_with_zero_codes_unit_scales():
    table = np.array([[5, 2, 9], [0, 7, 3]], np.int32)
    rng = np.random.default_rng(4)
    nk = rng.standard_normal((2, 7, 2, 16), dtype=np.float32)
    nv = rng.standard_normal((2, 7, 2, 16), dtype=np.float32)
    _write_quant_both(
        jk.write_prompt_pages_quant, tk.write_prompt_pages_quant,
        (jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(table), 4),
        (_t(nk), _t(nv), _t(table), 4))
    kq, ks, vq, vs = (_t(a) for a in _quant_pages(P=12))
    tk.write_prompt_pages_quant(kq, ks, vq, vs, _t(nk), _t(nv), _t(table), 4)
    # position 7 of each row (page slot 1, offset 3) is the padded tail
    for b, page in ((0, 2), (1, 7)):
        assert not kq[:, page, 3].any() and (ks[:, page, 3] == 1.0).all()


@pytest.mark.parametrize("start", [[0, 3, 9], [2, 8, 12], [10, 11, 30]])
def test_write_chunk_pages_quant_drops_past_capacity(start):
    table = np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8]], np.int32)
    st = np.array(start, np.int32)
    rng = np.random.default_rng(sum(start))
    nk = rng.standard_normal((3, 6, 2, 16), dtype=np.float32)
    nv = rng.standard_normal((3, 6, 2, 16), dtype=np.float32)
    _write_quant_both(
        jk.write_chunk_pages_quant, tk.write_chunk_pages_quant,
        (jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(table),
         jnp.asarray(st), 4), (_t(nk), _t(nv), _t(table), _t(st), 4),
        seed=sum(start))


# the fused int8 K/V write's plain version: (mode, rows a sequence, starts)
# over 3 sequences of 3 pages of 4 (capacity 12)
WRITE_CASES = [
    ("token", 1, [0, 5, 11]),       # in capacity, the last slot of a table
    ("token", 1, [3, 12, 40]),      # at capacity and past it: dropped
    ("chunk", 6, [0, 3, 9]),        # the last rows run past capacity
    ("chunk", 5, [12, 2, 7]),       # a sequence wholly past capacity
    ("prompt", 8, None),            # whole pages
    ("prompt", 7, None),            # a padded tail: codes 0, scale 1.0
    ("prompt", 1, None),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("KV", [1, 4])
@pytest.mark.parametrize("mode,rows,start", WRITE_CASES)
def test_write_kv_quant_plain_matches_jax(dtype, KV, mode, rows, start):
    """The fused K/V write's plain version (and the writers over it) against
    JAX's ``write_{token,chunk,prompt}_pages_quant`` on the same numpy
    inputs: every page plane bit for bit, the untouched slots included."""
    table = np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8]], np.int32)
    rng = np.random.default_rng(rows * 10 + KV)
    nk, nv = (rng.standard_normal((3, rows, KV, 16), dtype=np.float32) * 3
              for _ in range(2))
    nk[0, 0] = 0.0                                 # a zero row: scale 1.0
    if dtype == "bfloat16":
        nk, nv = (x.astype(ml_dtypes.bfloat16).astype(np.float32)
                  for x in (nk, nv))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    pages = _quant_pages(KV=KV, P=12, seed=rows)
    new = [_t(nk).to(tdt), _t(nv).to(tdt)]
    jargs = [jnp.asarray(nk, jdt), jnp.asarray(nv, jdt), jnp.asarray(table)]
    targs = new + [_t(table)]
    st = None if start is None else np.array(start, np.int32)
    if mode == "token":
        jfn, tfn = jk.write_token_pages_quant, tk.write_token_pages_quant
        jargs[:2] = [a[:, 0] for a in jargs[:2]]
        targs[:2] = [a[:, 0] for a in targs[:2]]
    elif mode == "chunk":
        jfn, tfn = jk.write_chunk_pages_quant, tk.write_chunk_pages_quant
    else:
        jfn, tfn = jk.write_prompt_pages_quant, tk.write_prompt_pages_quant
    if st is not None:
        jargs.append(jnp.asarray(st))
        targs.append(_t(st))
    want = jfn(*(jnp.asarray(a) for a in pages), *jargs, 4)
    planes = [_t(a.copy()) for a in pages]
    tfn(*planes, *targs, 4)
    direct = [_t(a.copy()) for a in pages]
    tk.write_kv_quant_reference(*direct, *new, _t(table),
                                None if st is None else _t(st), 4)
    for g, d, w in zip(planes, direct, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(d.numpy(), np.asarray(w))


@pytest.mark.parametrize("arm", ["xla", "pallas_v2"])
@pytest.mark.parametrize("phase", ["decode", "chunk", "prompt"])
def test_paged_step_int8_writes_plain_on_the_xla_arm(arm, phase,
                                                     monkeypatch):
    """The ``xla`` arm writes int8-resident K/V through the fused write's
    plain version on every device (so on the card it is a plain arm to
    hold the kernel arm to); ``pallas_v2`` asks for the kernel."""
    asked = []
    real = tk.write_kv_quant

    def spy(*a):
        asked.append(a[9])
        return real(*a)

    monkeypatch.setattr(tk, "write_kv_quant", spy)
    kq, ks, vq, vs = (_t(a) for a in _quant_pages(P=12))
    T = {"decode": 1, "chunk": 3, "prompt": 5}[phase]
    rng = np.random.default_rng(1)
    q = _t(rng.standard_normal((2, T, 4, 16), dtype=np.float32))
    k = _t(rng.standard_normal((2, T, 2, 16), dtype=np.float32))
    table = _t(np.array([[0, 1, 2], [3, 4, 5]], np.int32))
    start = _t(np.array([0, 0] if phase == "prompt" else [2, 5], np.int32))
    out = tk.paged_attention_step(
        q, k, k, kq, vq, table, start, 4, continuation=phase == "chunk",
        prefill=phase == "prompt", paged_kernel=arm,
        flash_force_reference=True, kps=ks, vps=vs)
    assert asked == [arm == "xla"] and out.shape == q.shape


# --------------------------------- B7 and B8 plain versions vs the Pallas
def _case(mode, G, seed):
    """Decode (C = 1, lens with an empty row) or chunk (C = 5) inputs over
    pages with stale table entries past each row's frontier."""
    KV, ps, Dh = 2, 4, 16
    C, B, mp = (1, 4, 5) if mode == "decode" else (5, 3, 6)
    lens = (np.array([0, 1, 7, 20], np.int32) if mode == "decode"
            else np.array([0, 5, 13], np.int32))
    used = -(-(lens + (C if C > 1 else 0)) // ps)
    live, stale = _table(B, mp, 24, seed=seed)
    table = np.where(np.arange(mp)[None] < used[:, None], live, stale)
    rng = np.random.default_rng(seed + 11)
    shape = (B, KV * G, Dh) if mode == "decode" else (B, C, KV * G, Dh)
    return rng.standard_normal(shape, dtype=np.float32), table, lens


@pytest.mark.parametrize("mode", ["decode", "chunk"])
@pytest.mark.parametrize("G", [1, 4])
def test_quant_matches_pallas_v2_quant_interpret(mode, G):
    q, table, lens = _case(mode, G, seed=G)
    pages = _quant_pages(seed=G)
    jfn = (jk.paged_decode_attention_v2_quant if mode == "decode"
           else jk.paged_chunk_attention_v2_quant)
    tfn = (paged_decode_attention_quant if mode == "decode"
           else paged_chunk_attention_quant)
    want = np.asarray(jfn(jnp.asarray(q), *(jnp.asarray(p) for p in pages),
                          jnp.asarray(table), jnp.asarray(lens),
                          pages_per_block=2, interpret=True))
    got = tfn(_t(q), *(_t(p) for p in pages), _t(table), _t(lens))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if mode == "decode":
        assert not got[0].any(), "an empty row must give zeros"


@pytest.mark.parametrize("mode", ["decode", "chunk"])
@pytest.mark.parametrize("G", [1, 4])
def test_v1_split_matches_pallas_v1_interpret(mode, G, monkeypatch):
    q, table, lens = _case(mode, G, seed=G + 2)
    kp, vp = _pages(seed=G + 2)
    jfn = (jk.paged_decode_attention if mode == "decode"
           else jk.paged_chunk_attention)
    tfn = (paged_decode_attention_v1 if mode == "decode"
           else paged_chunk_attention_v1)
    want = np.asarray(jfn(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                          jnp.asarray(table), jnp.asarray(lens),
                          interpret=True))
    # small splits, so several partials combine (and some are empty)
    from deepspeed_tpu_torch.inference import paged_attention_cuda as pac

    for keys in (4, 8, pac.SPLIT_KEYS):
        monkeypatch.setattr(pac, "SPLIT_KEYS", keys)
        got = pac.paged_chunk_attention_split_reference(
            _t(q)[:, None] if mode == "decode" else _t(q), _t(kp), _t(vp),
            _t(table), _t(lens - 1 if mode == "decode" else lens),
            split_keys=keys)
        got = got[:, 0] if mode == "decode" else got
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    got = tfn(_t(q), _t(kp), _t(vp), _t(table), _t(lens))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if mode == "decode":
        assert not got[0].any(), "an empty row must give zeros"


def test_paged_step_rejects_int8_pages_on_v1():
    kq, ks, vq, vs = (_t(a) for a in _quant_pages())
    q = torch.zeros((1, 1, 2, 16))
    with pytest.raises(ValueError, match="pallas_v1"):
        tk.paged_attention_step(
            q, q[:, :, :2], q[:, :, :2], kq, vq,
            torch.zeros((1, 6), dtype=torch.int32),
            torch.zeros((1,), dtype=torch.int32), 4, continuation=False,
            prefill=False, paged_kernel="pallas_v1",
            flash_force_reference=True, kps=ks, vps=vs)
