"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at shapes beyond the smoke's (every head dim, both dtypes, ragged
tails, packed segments, odd page sizes, unaligned logits rows, odd leaf
sizes, odd group sizes, NaN and inf groups, offsets past 2^31).  Marked
``cuda``: they skip without a GPU.  On the card (the conftest imports JAX, which the GPU
machine need not have):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py -q
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator("cuda").manual_seed(0)


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _segments(B, T):
    seg = torch.ones((B, T), dtype=torch.int32, device="cuda")
    for b in range(B):
        seg[b, T // 3 + b:] = 2
        seg[b, (2 * T) // 3:] = 3
    return seg


# (dtype, D, T, S, G, causal, with_seg): every dtype and head dim on a few
# ragged shapes; then the tensor-core body's grid (bf16, D 64 and 128): T
# around its 64-row warpgroups and 128-key tiles, GQA groups 1, 4 and 8,
# causal or not, packed segments (at T = 300 a whole key tile lies outside
# the last segment's rows), T != S both ways, and the training shape T = 2047
FLASH_FWD_CASES = [
    (dtype, D, T, S, G, causal, False)
    for dtype in (torch.float32, torch.bfloat16) for D in (16, 32, 64, 128)
    for T, S, G, causal in ((1, 1, 1, True), (37, 37, 4, True),
                            (130, 130, 2, False), (64, 200, 1, False),
                            (200, 64, 8, True))
] + [
    (torch.bfloat16, D, T, T, G, causal, with_seg)
    for D in (64, 128) for T in (1, 63, 64, 65, 127, 129, 300)
    for G in (1, 4, 8) for causal in (True, False) for with_seg in (False, True)
] + [
    (torch.bfloat16, D, T, S, G, causal, with_seg)
    for D in (64, 128)
    for T, S, G, causal, with_seg in ((100, 300, 4, False, False),
                                      (300, 100, 4, False, False),
                                      (2047, 2047, 4, True, False),
                                      (2047, 2047, 4, True, True))
]


@pytest.mark.parametrize("dtype,D,T,S,G,causal,with_seg", FLASH_FWD_CASES)
def test_flash_fwd_matches_plain(gen, dtype, D, T, S, G, causal, with_seg):
    from deepspeed_tpu_torch.ops.attention_cuda import (
        flash_fwd, flash_fwd_reference, flash_fwd_tiled_reference)

    q = _randn(gen, (2, T, 2 * G, D), dtype)
    k = _randn(gen, (2, S, 2, D), dtype)
    v = _randn(gen, (2, S, 2, D), dtype)
    seg = _segments(2, T) if with_seg else None
    o, lse = flash_fwd(q, k, v, causal=causal, seg=seg)
    ro, rlse = flash_fwd_reference(q, k, v, causal=causal, seg=seg)
    to, tlse = flash_fwd_tiled_reference(q, k, v, causal=causal, seg=seg)
    torch.cuda.synchronize()
    assert (o.float() - ro.float()).abs().max().item() <= TOL[dtype]
    assert (lse - rlse).abs().max().item() <= 1e-3
    assert (o.float() - to.float()).abs().max().item() <= TOL[dtype]
    assert (lse - tlse).abs().max().item() <= 1e-3


def test_flash_fwd_counts_launches_per_body(gen):
    from deepspeed_tpu_torch.ops.attention_cuda import (flash_fwd,
                                                        flash_fwd_reference)

    def launch(dtype, D, misalign=False):
        shape = (1, 70, 4, D)
        n = 70 * 4 * D
        if misalign:          # contiguous, but 2 bytes off TMA's alignment
            buf = _randn(gen, (3 * n + 1,), dtype)
            q, k, v = (buf[1 + i * n:1 + (i + 1) * n].view(shape)
                       for i in range(3))
        else:
            q, k, v = (_randn(gen, shape, dtype) for _ in range(3))
        before = (flash_fwd.launches, dict(flash_fwd.body_launches))
        o, _ = flash_fwd(q, k, v)
        ro, _ = flash_fwd_reference(q, k, v)
        torch.cuda.synchronize()
        assert (o.float() - ro.float()).abs().max().item() <= TOL[dtype]
        assert flash_fwd.launches == before[0] + 1
        return {b: n - before[1][b] for b, n in flash_fwd.body_launches.items()}

    assert launch(torch.bfloat16, 128) == {"wgmma": 1, "scalar": 0}
    assert launch(torch.bfloat16, 64) == {"wgmma": 1, "scalar": 0}
    assert launch(torch.float32, 128) == {"wgmma": 0, "scalar": 1}
    assert launch(torch.bfloat16, 32) == {"wgmma": 0, "scalar": 1}
    # a view off TMA's alignment is copied and keeps the tensor-core body
    assert launch(torch.bfloat16, 128, misalign=True) == {"wgmma": 1,
                                                          "scalar": 0}


def _rel_err(got, want):
    """Largest |error| over the largest |value|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


# T = 1: a lone key makes dq and dk exactly 0; both sides hold only the
# f32 rounding of dO.v - delta (a few ulps of a sum of D products of unit
# normals) times |k| * scale, so they are held to an absolute bound instead
ZERO_GRAD_ATOL = 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("T,G,causal,with_seg", [
    (1, 1, True, False), (37, 4, True, False), (130, 2, False, False),
    (200, 4, True, True), (129, 1, False, True)])
def test_flash_bwd_matches_plain(gen, dtype, D, T, G, causal, with_seg):
    from deepspeed_tpu_torch.ops.attention_cuda import (
        flash_bwd, flash_bwd_reference, flash_fwd, flash_fwd_reference)

    q = _randn(gen, (2, T, 2 * G, D), dtype)
    k = _randn(gen, (2, T, 2, D), dtype)
    v = _randn(gen, (2, T, 2, D), dtype)
    do = _randn(gen, (2, T, 2 * G, D), dtype)
    seg = _segments(2, T) if with_seg else None
    o, lse = flash_fwd(q, k, v, causal=causal, seg=seg)
    ro, rlse = flash_fwd_reference(q, k, v, causal=causal, seg=seg)
    got = flash_bwd(q, k, v, o, lse, do, seg, causal)
    want = flash_bwd_reference(q, k, v, o, lse, do, seg, causal)
    torch.cuda.synchronize()
    assert (o.float() - ro.float()).abs().max().item() <= TOL[dtype]
    assert (lse - rlse).abs().max().item() <= 1e-3
    rel = {torch.float32: 1e-4, torch.bfloat16: 2e-2}[dtype]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype == dtype
        if T == 1 and name != "dv":
            assert g.float().abs().max().item() <= ZERO_GRAD_ATOL, name
            assert w.float().abs().max().item() <= ZERO_GRAD_ATOL, name
        else:
            assert _rel_err(g, w) <= rel, name


# the tensor-core backward bodies (bf16, D 64 and 128): T around their
# 64-key tiles and 128-row (dQ) / 64-row (dK/dV) tiles, GQA groups 1, 4 and
# 8, causal or not, packed segments; T != S both ways; the training shape
FLASH_BWD_WGMMA_CASES = [
    (D, T, T, G, causal, with_seg)
    for D in (64, 128) for T in (1, 63, 64, 65, 127, 129, 300)
    for G in (1, 4, 8) for causal in (True, False) for with_seg in (False, True)
] + [
    (D, T, S, 4, causal, False)
    for D in (64, 128) for T, S in ((100, 300), (300, 100))
    for causal in (True, False)
] + [
    (D, 2047, 2047, 4, True, with_seg)
    for D in (64, 128) for with_seg in (False, True)
]
# the smoke's gate (chip_smoke.FLASH_BWD_REL_TOL) at the training shape;
# elsewhere the bf16 bound of test_flash_bwd_matches_plain, whose few-row
# cases put a bf16 ulp of a small maximum in play
FLASH_BWD_REL_TOL = 4e-3


@pytest.mark.parametrize("D,T,S,G,causal,with_seg", FLASH_BWD_WGMMA_CASES)
def test_flash_bwd_wgmma_matches_plain_and_tiled(gen, D, T, S, G, causal,
                                                 with_seg):
    from deepspeed_tpu_torch.ops.attention_cuda import (
        flash_bwd, flash_bwd_dkv, flash_bwd_dq, flash_bwd_reference,
        flash_bwd_tiled_reference, flash_fwd_reference)

    dt = torch.bfloat16
    q = _randn(gen, (2, T, 2 * G, D), dt)
    k = _randn(gen, (2, S, 2, D), dt)
    v = _randn(gen, (2, S, 2, D), dt)
    do = _randn(gen, (2, T, 2 * G, D), dt)
    seg = _segments(2, T) if with_seg else None
    o, lse = flash_fwd_reference(q, k, v, causal=causal, seg=seg)
    before = (dict(flash_bwd_dq.body_launches),
              dict(flash_bwd_dkv.body_launches))
    got = flash_bwd(q, k, v, o, lse, do, seg, causal)
    want = flash_bwd_reference(q, k, v, o, lse, do, seg, causal)
    twin = flash_bwd_tiled_reference(q, k, v, o, lse, do, seg, causal)
    torch.cuda.synchronize()
    assert flash_bwd_dq.body_launches["wgmma"] == before[0]["wgmma"] + 1
    assert flash_bwd_dkv.body_launches["wgmma"] == before[1]["wgmma"] + 1
    rel = FLASH_BWD_REL_TOL if T == 2047 else TOL[dt]
    for name, g, w, t in zip(("dq", "dk", "dv"), got, want, twin):
        assert g.dtype == dt and torch.isfinite(g.float()).all(), name
        if T == 1 and name != "dv":
            assert g.float().abs().max().item() <= ZERO_GRAD_ATOL, name
            continue
        assert _rel_err(g, w) <= rel, name
        assert _rel_err(g, t) <= rel, name


# the dQ kernels' delta against flash_delta: the same f32 products summed in
# another order (a few f32 ulps of the row's sum of |O * dO|), held to 1e-5
# of the largest |delta|
DELTA_REL_TOL = 1e-5


def _dq_into(q, k, v, o, do, lse, seg, causal, dq, delta):
    """dstt_flash_bwd_dq into the caller's dq and delta buffers, on the body
    the wrapper would pick."""
    import math

    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops.attention_cuda import flash_bwd_body

    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    err = _build.lib().dstt_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        None if seg is None else seg.data_ptr(), dq.data_ptr(), B, T, S, H,
        KV, D, 1.0 / math.sqrt(D), int(causal), _build.DTYPE_CODES[q.dtype],
        int(flash_bwd_body(q) == "wgmma"), _build.stream_of(q))
    _build.check("dstt_flash_bwd_dq", err)


# (dtype, D) on both bodies: f32 and bf16 D 32 take the scalar one, bf16 D
# 64 / 128 the tensor-core one.  Segment layouts: none; thirds; or one id per
# 128 rows, so that every 128-row item of the tensor-core body sees only
# its own rows' keys and skips every other key tile (no item can skip all
# of them: with T == S each row's own key is live)
@pytest.mark.parametrize("seg_kind", [None, "thirds", "items"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [1, 65, 300])
@pytest.mark.parametrize("dtype,D", [(torch.float32, 64), (torch.float32, 128),
                                     (torch.bfloat16, 32),
                                     (torch.bfloat16, 64),
                                     (torch.bfloat16, 128)])
def test_flash_bwd_dq_writes_delta(gen, dtype, D, T, causal, seg_kind):
    from deepspeed_tpu_torch.ops.attention_cuda import (
        flash_bwd_dq, flash_delta, flash_fwd_reference)

    q, o, do = (_randn(gen, (2, T, 8, D), dtype) for _ in range(3))
    k, v = (_randn(gen, (2, T, 2, D), dtype) for _ in range(2))
    seg = None
    if seg_kind == "thirds":
        seg = _segments(2, T)
    elif seg_kind == "items":
        seg = (torch.arange(T, device="cuda", dtype=torch.int32) // 128
               ).expand(2, T).contiguous()
    _, lse = flash_fwd_reference(q, k, v, causal=causal, seg=seg)
    # every row below T must be written: the buffers start as NaN
    dq = torch.full_like(q, float("nan"))
    delta = torch.full((2, 8, T), float("nan"), device="cuda")
    _dq_into(q, k, v, o, do, lse, seg, causal, dq, delta)
    got_dq, got_delta = flash_bwd_dq(q, k, v, o, do, lse, seg, causal)
    want = flash_delta(o, do)
    torch.cuda.synchronize()
    assert not delta.isnan().any() and not dq.isnan().any()
    assert _rel_err(delta, want) <= DELTA_REL_TOL
    # the wrapper launches the same kernel: the same bits
    assert got_delta.shape == want.shape and got_delta.dtype == torch.float32
    assert torch.equal(got_delta, delta) and torch.equal(got_dq, dq)


def test_flash_bwd_counts_launches_per_body(gen):
    from deepspeed_tpu_torch.ops.attention_cuda import (
        flash_bwd_dkv, flash_bwd_dq, flash_bwd_reference, flash_delta,
        flash_fwd_reference)

    def launch(dtype, D, misalign=False):
        shape = (1, 70, 4, D)
        n = 70 * 4 * D
        if misalign:          # contiguous, but 2 bytes off TMA's alignment
            buf = _randn(gen, (4 * n + 1,), dtype)
            q, k, v, do = (buf[1 + i * n:1 + (i + 1) * n].view(shape)
                           for i in range(4))
        else:
            q, k, v, do = (_randn(gen, shape, dtype) for _ in range(4))
        o, lse = flash_fwd_reference(q, k, v)
        o = o.contiguous()            # the kernel's layout
        before = [(f.launches, dict(f.body_launches))
                  for f in (flash_bwd_dq, flash_bwd_dkv)]
        dq, delta = flash_bwd_dq(q, k, v, o, do, lse)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta)
        want = flash_bwd_reference(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        assert _rel_err(delta, flash_delta(o, do)) <= DELTA_REL_TOL
        for g, w in zip((dq, dk, dv), want):
            assert _rel_err(g, w) <= TOL[dtype]
        counts = []
        for f, (n0, b0) in zip((flash_bwd_dq, flash_bwd_dkv), before):
            assert f.launches == n0 + 1
            counts.append({b: c - b0[b] for b, c in f.body_launches.items()})
        assert counts[0] == counts[1]
        return counts[0]

    assert launch(torch.bfloat16, 128) == {"wgmma": 1, "scalar": 0}
    assert launch(torch.bfloat16, 64) == {"wgmma": 1, "scalar": 0}
    assert launch(torch.float32, 128) == {"wgmma": 0, "scalar": 1}
    assert launch(torch.bfloat16, 32) == {"wgmma": 0, "scalar": 1}
    # a view off TMA's alignment is copied and keeps the tensor-core body
    assert launch(torch.bfloat16, 128, misalign=True) == {"wgmma": 1,
                                                          "scalar": 0}


@pytest.mark.parametrize("dtype,D", [(torch.float32, 64),
                                     (torch.bfloat16, 128)])
def test_flash_attention_function_grads_on_the_card(gen, dtype, D,
                                                    monkeypatch):
    from deepspeed_tpu_torch.ops import attention_cuda as ac
    from deepspeed_tpu_torch.ops.attention import _reference, flash_attention

    def no_plain_delta(*a):
        raise AssertionError("the plain O.dO reduction ran on the card")

    # the dQ kernel forms delta: the plain reduction is off the CUDA path
    monkeypatch.setattr(ac, "flash_delta", no_plain_delta)

    q, k, v = (_randn(gen, s, dtype).requires_grad_(True)
               for s in ((1, 96, 8, D), (1, 96, 2, D), (1, 96, 2, D)))
    seg = _segments(1, 96)
    do = _randn(gen, (1, 96, 8, D), dtype)
    counts = (ac.flash_fwd, ac.flash_bwd_dq, ac.flash_bwd_dkv)
    before = [(f.launches, dict(f.body_launches)) for f in counts]
    flash_attention(q, k, v, segment_ids=seg).backward(do)
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    _reference(q, k, v, segment_ids=seg).backward(do)
    for g, t in zip(got, (q, k, v)):
        assert _rel_err(g, t.grad) <= {torch.float32: 1e-4,
                                       torch.bfloat16: 2e-2}[dtype]
    body = "wgmma" if dtype == torch.bfloat16 else "scalar"
    for f, (n0, b0) in zip(counts, before):
        assert f.launches == n0 + 1
        assert f.body_launches[body] == b0[body] + 1


def test_f32_matmul_on_the_card(gen):
    # bf16 operands with an f32 result against the product of the upcast
    # operands: the same products (exact in f32) summed in another order,
    # ~sqrt(K) f32 roundings of a sum of K = 4096 (~4e-6 of the largest
    # value), held at 1e-5; the backward is the upcast product's, bit for bit
    from deepspeed_tpu_torch.ops.losses import f32_matmul

    a = _randn(gen, (3, 100, 4096), torch.bfloat16).requires_grad_(True)
    b = _randn(gen, (4096, 1000), torch.bfloat16).requires_grad_(True)
    g = _randn(gen, (3, 100, 1000), torch.float32)
    got = f32_matmul(a, b)
    want = a.float() @ b.float()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel_err(got, want) <= 1e-5
    da, db = torch.autograd.grad(got, (a, b), g)
    wa, wb = torch.autograd.grad(want, (a, b), g)
    assert da.dtype == db.dtype == torch.bfloat16
    assert torch.equal(da, wa) and torch.equal(db, wb)
    # a column slice of the head, as the chunked loss takes it
    sl = b.detach()[:, 100:612]
    assert _rel_err(f32_matmul(a.detach(), sl), a.float() @ sl.float()) <= 1e-5


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,wd", [(1, 0.0), (1000, 0.1), (2_100_001, 0.1)])
def test_fused_adam_matches_plain(gen, g_dtype, p_dtype, n, wd):
    from deepspeed_tpu_torch.ops.adam_cuda import (adam_scalars, adam_update,
                                                   adam_update_reference)

    g = _randn(gen, (n,), g_dtype)
    p = _randn(gen, (n,), p_dtype)
    m = _randn(gen, (n,), torch.float32)
    v = _randn(gen, (n,), torch.float32).abs()
    c1, c2 = adam_scalars(0.9, 0.999, 3)
    got = adam_update(g, m, v, p, c1, c2, 1e-3, wd=wd)
    want = adam_update_reference(g, m, v, p, c1, c2, 1e-3, wd=wd)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def test_fused_adam_rejects_what_it_cannot_take(gen):
    from deepspeed_tpu_torch.ops.adam_cuda import adam_update

    g = _randn(gen, (8, 4), torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        adam_update(g.T, g.T, g.T, g.T, 1.0, 1.0, 1e-3)
    with pytest.raises(ValueError, match="float32"):
        adam_update(g, g.half(), g, g, 1.0, 1.0, 1e-3)


def test_flash_fwd_rejects_what_it_cannot_take(gen):
    from deepspeed_tpu_torch.ops.attention_cuda import flash_fwd

    q = _randn(gen, (1, 8, 2, 48), torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        flash_fwd(q, q, q)
    q = _randn(gen, (1, 8, 2, 16), torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        flash_fwd(q, q, q)
    q = _randn(gen, (1, 2, 8, 16), torch.float32).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_fwd(q, q, q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("C,G,ps", [(1, 4, 16), (1, 1, 8), (5, 4, 8),
                                    (40, 2, 16), (256, 4, 16)])
def test_paged_matches_plain(gen, dtype, D, C, G, ps):
    from deepspeed_tpu_torch.inference.paged_attention_cuda import (
        paged_chunk_attention, paged_chunk_attention_reference)

    B, KV, mp = 4, 2, 40
    starts = [0, 3, 97, 300] if C > 1 else [-1, 0, 97, 300]
    P = B * mp + 1
    perm = torch.randperm(P - 1, generator=gen, device="cuda").int()
    table = perm[:B * mp].reshape(B, mp).contiguous()
    kp = _randn(gen, (KV, P, ps, D), dtype)
    vp = _randn(gen, (KV, P, ps, D), dtype)
    q = _randn(gen, (B, C, KV * G, D), dtype)
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    out = paged_chunk_attention(q, kp, vp, table, st)
    ref = paged_chunk_attention_reference(q, kp, vp, table, st)
    torch.cuda.synchronize()
    if C == 1:                      # start -1: the empty row gives zeros
        assert not out[0].any()
        out, ref = out[1:], ref[1:]
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


def _paged_case(gen, C, G, ps, D, dtype):
    """Four rows over distinct random pages (start -1 on an empty decode
    row), the table filled to its width."""
    B, KV, mp = 4, 2, 40
    starts = [0, 3, 97, 300] if C > 1 else [-1, 0, 97, 300]
    P = B * mp + 1
    perm = torch.randperm(P - 1, generator=gen, device="cuda").int()
    table = perm[:B * mp].reshape(B, mp).contiguous()
    kp = _randn(gen, (KV, P, ps, D), dtype)
    vp = _randn(gen, (KV, P, ps, D), dtype)
    q = _randn(gen, (B, C, KV * G, D), dtype)
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    return q, kp, vp, table, st


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("C,G,ps", [(1, 4, 16), (1, 1, 8), (5, 4, 8),
                                    (40, 2, 16), (256, 4, 16)])
def test_paged_quant_matches_plain(gen, dtype, D, C, G, ps):
    from deepspeed_tpu_torch.inference.kernels import quantize_kv_rows
    from deepspeed_tpu_torch.inference.paged_attention_cuda import (
        paged_chunk_attention_quant, paged_chunk_attention_quant_reference)

    q, kp, vp, table, st = _paged_case(gen, C, G, ps, D, dtype)
    kq, ks = quantize_kv_rows(kp)
    vq, vs = quantize_kv_rows(vp)
    out = paged_chunk_attention_quant(q, kq, ks, vq, vs, table, st)
    ref = paged_chunk_attention_quant_reference(q, kq, ks, vq, vs, table, st)
    torch.cuda.synchronize()
    if C == 1:                      # start -1: the empty row gives zeros
        assert not out[0].any()
        out, ref = out[1:], ref[1:]
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("C,G,ps", [(1, 4, 16), (1, 1, 8), (5, 4, 8),
                                    (40, 2, 16), (256, 4, 16)])
def test_paged_v1_split_matches_plain(gen, dtype, D, C, G, ps):
    """B8 on its body: the split-key pair (f32, head_dim 16) against the
    split plain version, two launches; B5's Hopper body (bf16, head_dim 64 /
    128) against its tiled twin, one launch; both against the plain
    version."""
    from deepspeed_tpu_torch.inference.paged_attention_cuda import (
        paged_body, paged_chunk_attention_reference,
        paged_chunk_attention_split_reference,
        paged_chunk_attention_tiled_reference, paged_chunk_attention_v1)

    q, kp, vp, table, st = _paged_case(gen, C, G, ps, D, dtype)
    body = paged_body(q)
    before = paged_chunk_attention_v1.launches
    bodies = dict(paged_chunk_attention_v1.body_launches)
    out = paged_chunk_attention_v1(q, kp, vp, table, st)
    twin = (paged_chunk_attention_tiled_reference if body == "sm90"
            else paged_chunk_attention_split_reference)
    split = twin(q, kp, vp, table, st)
    torch.cuda.synchronize()
    n = 1 if body == "sm90" else 2
    assert paged_chunk_attention_v1.launches == before + n
    bodies[body] += n
    assert paged_chunk_attention_v1.body_launches == bodies
    if C == 1:                      # start -1: the empty row gives zeros
        assert not out[0].any() and not split[0].any()
        out, split = out[1:], split[1:]
        q, table, st = q[1:], table[1:], st[1:]
    assert (out.float() - split.float()).abs().max().item() <= TOL[dtype]
    ref = paged_chunk_attention_reference(q, kp, vp, table, st)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


def _sm90_paged_case(gen, C, G, ps, D):
    """Rows at history lengths 0 (an empty decode row), 1, ps - 1, ps, a
    decode span - 1 and + 1, and 1024, over distinct random live pages.  The
    kernel's pool holds NaN wherever no row may read: in every page that a
    table slot past a row's frontier points at, and past the frontier in
    each row's last page; the plain versions get the same pool with those
    NaNs as zeros.  Returns q, the two pools, the table and the starts."""
    from deepspeed_tpu_torch.inference.paged_attention_cuda import (
        decode_span_pages)

    KV, mp = 2, -(-(1024 + C) // ps) + 1
    span = decode_span_pages(ps, mp) * ps
    hist = [0, 1, ps - 1, ps, span - 1, span + 1, 1024]
    starts = [h - 1 for h in hist] if C == 1 else hist
    ends = [s + C for s in starts]                    # each row's frontier
    B = len(hist)
    used = [-(-max(e, 0) // ps) for e in ends]
    n_live, n_nan = sum(used), 4
    P = n_live + n_nan
    perm = torch.randperm(n_live, generator=gen, device="cuda").int()
    table = torch.randint(n_live, P, (B, mp), generator=gen, device="cuda",
                          dtype=torch.int32)
    off = 0
    for b, u in enumerate(used):
        table[b, :u] = perm[off:off + u]
        off += u
    pools = []
    for _ in range(2):
        x = torch.randn((KV, P, ps, D), generator=gen, device="cuda")
        x[:, n_live:] = float("nan")
        for b, e in enumerate(ends):
            if e % ps:                                # past the frontier
                x[:, table[b, e // ps], e % ps:] = float("nan")
        pools.append(x)
    q = _randn(gen, (B, C, KV * G, D), torch.bfloat16)
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    return q, pools, table, st


# the Hopper body of B5 and B7 (bf16, head_dim 64 / 128): decode (C * G <=
# 16 rows, split over spans) and chunks (tensor cores) at every GQA group
# and page size of the engines
PAGED_SM90_CASES = [(D, G, C, ps) for D in (64, 128) for G in (1, 4, 8)
                    for C in (1, 7, 64, 256) for ps in (8, 16, 32)]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("D,G,C,ps", PAGED_SM90_CASES)
def test_paged_sm90_body_matches_plain(gen, quant, D, G, C, ps):
    from deepspeed_tpu_torch.inference.kernels import quantize_kv_rows
    from deepspeed_tpu_torch.inference.paged_attention_cuda import (
        paged_chunk_attention, paged_chunk_attention_quant,
        paged_chunk_attention_quant_reference,
        paged_chunk_attention_reference)

    q, (kp, vp), table, st = _sm90_paged_case(gen, C, G, ps, D)
    if quant:
        kp[:, ::3, 1] = 0.0                 # zero-amax rows: scale 1.0
        kq, ks = quantize_kv_rows(kp)
        vq, vs = quantize_kv_rows(vp)
        fn = paged_chunk_attention_quant
        args = (kq, ks, vq, vs, table, st)
        # the plain version over the same codes, NaN rows as zero rows
        clean = [torch.where(torch.isnan(x), 0.0, x) for x in (ks, vs)]
        kq0 = torch.where(torch.isnan(ks), 0, kq.int()).to(torch.int8)
        vq0 = torch.where(torch.isnan(vs), 0, vq.int()).to(torch.int8)
        ref = paged_chunk_attention_quant_reference(
            q, kq0, clean[0], vq0, clean[1], table, st)
    else:
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
        fn = paged_chunk_attention
        args = (kp, vp, table, st)
        ref = paged_chunk_attention_reference(
            q, torch.nan_to_num(kp, nan=0.0), torch.nan_to_num(vp, nan=0.0),
            table, st)
    before = dict(fn.body_launches)
    out = fn(q, *args)
    again = fn(q, *args)
    torch.cuda.synchronize()
    assert fn.body_launches == {"sm90": before["sm90"] + 2,
                                "scalar": before["scalar"]}
    assert torch.isfinite(out).all(), "a read past a frontier"
    assert torch.equal(out, again), "two launches disagree"
    if C == 1:                      # start -1: the empty row gives zeros
        assert not out[0].any()
        out, ref = out[1:], ref[1:]
    assert (out.float() - ref.float()).abs().max().item() <= TOL[torch.bfloat16]


@pytest.mark.parametrize("D,G,C,ps", [c for c in PAGED_SM90_CASES
                                      if c[2] in (1, 256)])
def test_paged_v1_sm90_body_matches_tiled(gen, D, G, C, ps):
    """B8's launches on the Hopper body (the pallas_v1 arm of the bf16
    engines) against the body's tiled twin, with NaN pages behind every
    frontier: one launch a call."""
    from deepspeed_tpu_torch.inference.paged_attention_cuda import (
        paged_chunk_attention_tiled_reference, paged_chunk_attention_v1)

    q, (kp, vp), table, st = _sm90_paged_case(gen, C, G, ps, D)
    kb, vb = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    before = dict(paged_chunk_attention_v1.body_launches)
    out = paged_chunk_attention_v1(q, kb, vb, table, st)
    ref = paged_chunk_attention_tiled_reference(
        q, torch.nan_to_num(kb, nan=0.0), torch.nan_to_num(vb, nan=0.0),
        table, st)
    torch.cuda.synchronize()
    assert paged_chunk_attention_v1.body_launches == {
        "sm90": before["sm90"] + 1, "scalar": before["scalar"]}
    assert torch.isfinite(out).all(), "a read past a frontier"
    if C == 1:
        assert not out[0].any()
        out, ref = out[1:], ref[1:]
    assert (out.float() - ref.float()).abs().max().item() <= TOL[torch.bfloat16]


def test_paged_kernels_reject_what_they_cannot_take(gen):
    from deepspeed_tpu_torch.inference.paged_attention_cuda import (
        paged_chunk_attention_quant, paged_chunk_attention_v1)

    q, kp, vp, table, st = _paged_case(gen, 1, 2, 8, 16, torch.float32)
    sc = kp[..., :1].contiguous()
    with pytest.raises(ValueError, match="pages"):      # float pages
        paged_chunk_attention_quant(q, kp, sc, vp, sc, table, st)
    kq = kp.to(torch.int8)
    with pytest.raises(ValueError, match="scales"):
        paged_chunk_attention_quant(q, kq, sc.half(), kq, sc, table, st)
    with pytest.raises(ValueError, match="int32"):
        paged_chunk_attention_v1(q, kp, vp, table.long(), st)


@pytest.mark.parametrize("B,V,offset", [(1, 7, 0), (3, 1001, 0),
                                        (8, 128256, 0), (4, 4096, 1),
                                        (1, 128256, 0), (2, 128256, 0),
                                        (64, 128256, 0), (1, 128256, 1)])
def test_greedy_matches_argmax(gen, B, V, offset):
    from deepspeed_tpu_torch.ops.sampling_cuda import (fused_greedy_rows,
                                                       greedy_rows_reference)

    x = torch.randn((B * V + offset,), generator=gen, device="cuda")
    x = x[offset:].view(B, V)          # offset 1: rows not 16-byte aligned
    x[:, V // 3] = x[:, -1] = 100.0    # a tie in every row
    fused_greedy_rows.body_launches = dict.fromkeys(
        fused_greedy_rows.body_launches, 0)
    got = fused_greedy_rows(x)
    assert torch.equal(got.long(), torch.argmax(x, dim=-1))
    assert (got == V // 3).all()
    # B <= 132 splits each row over a cluster (B = 64: 4 spans)
    assert fused_greedy_rows.body_launches == {"cluster": 1, "row": 0}
    # NaN counts as the max: a row of NaN gives 0, a row with some NaN
    # gives its first NaN, ahead of the tied 100s
    x[0] = float("nan")
    x[-1, [V // 2, V - 1]] = float("nan")
    got = fused_greedy_rows(x)
    assert torch.equal(got, greedy_rows_reference(x))
    assert got[0].item() == 0
    assert got[-1].item() == (0 if B == 1 else V // 2)


def _greedy_exact(x):
    """The kernel against the plain version and torch.argmax: equal."""
    from deepspeed_tpu_torch.ops.sampling_cuda import (fused_greedy_rows,
                                                       greedy_rows_reference)

    got = fused_greedy_rows(x)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32
    assert torch.equal(got, greedy_rows_reference(x))
    assert torch.equal(got.long(), torch.argmax(x, dim=-1))
    return got


def _span_plan(x):
    """The spans the kernel reads for row 0 of ``x`` (its head is where
    that row's first 16-byte boundary falls): (S, edges)."""
    from deepspeed_tpu_torch.ops.sampling_cuda import greedy_split_plan

    width = 16 // x.element_size()
    head = (16 - x.data_ptr() % 16) % 16 // x.element_size()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return greedy_split_plan(x.shape[0], x.shape[1], sms, width, head)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("B,V", [(1, 128256), (8, 128256), (2, 50000),
                                 (64, 128256), (133, 128256), (34, 4099),
                                 (8, 20), (1, 63), (4, 1), (4, 5)])
def test_greedy_split_exact(gen, dtype, B, V):
    """Every split the batch picks on 132 SMs (16 spans at B <= 4, 8, 7
    at B = 34, 4 at B = 64, the row body at B = 133) and dtype: ties
    planted on each side of each span edge, a NaN row and an all -inf row,
    V below 16 spans of 16 bytes (empty spans), unaligned rows."""
    from deepspeed_tpu_torch.ops.sampling_cuda import fused_greedy_rows

    fused_greedy_rows.body_launches = {"cluster": 0, "row": 0}
    for offset in (0, 1):
        base = _randn(gen, (B * V + offset,), dtype)
        x = base[offset:].view(B, V)
        _greedy_exact(x)
        S, edges = _span_plan(x)
        inner = [e for e in edges[1:-1] if 0 < e < V]
        if inner:
            # the same max just left and right of every edge: the left wins
            x[:, inner] = 40.0
            x[:, [e - 1 for e in inner]] = 40.0
            got = _greedy_exact(x)
            assert (got == inner[0] - 1).all()
        if B > 1:
            x[0] = float("-inf")
            x[1, V // 2:] = float("nan")
            got = _greedy_exact(x)
            assert got[0].item() == 0 and got[1].item() == V // 2
    other = "cluster" if S == 1 else "row"
    assert fused_greedy_rows.body_launches[other] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 8])
def test_greedy_strided_last_position(gen, dtype, B):
    """``logits[:, -1]`` of a [B, 3, V] tensor, read in place."""
    V = 128256
    x = _randn(gen, (B, 3, V), dtype)
    x[:, 0] = 99.0                      # the other positions never count
    last = x[:, -1]
    assert last.stride(0) == 3 * V
    last[:, 77777] = last[:, 5] = 50.0
    got = _greedy_exact(last)
    assert (got == 5).all()


def test_greedy_rejects_what_it_cannot_take(gen):
    from deepspeed_tpu_torch.ops.sampling_cuda import fused_greedy_rows

    x = torch.randn((4, 100), generator=gen, device="cuda")
    for bad in (x.double(), x.int(), x.long()):
        with pytest.raises(ValueError, match="float32"):
            fused_greedy_rows(bad)
    with pytest.raises(ValueError, match="float32"):
        fused_greedy_rows(x[None])              # not [B, V]
    with pytest.raises(ValueError, match="contiguous"):
        fused_greedy_rows(x.t())


def _nan_equal(a, b):
    """Equal, with NaN equal to NaN (NaN bits may differ)."""
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,gsz", [(1, 1), (8, 128), (64, 128), (3, 768),
                                   (1000, 33), (5, 4096), (17, 7)])
def test_quantize_matches_plain(gen, dtype, G, gsz):
    from deepspeed_tpu_torch.ops.quant_cuda import (quantize_rows,
                                                    quantize_rows_reference)

    x = _randn(gen, (G, gsz), dtype) * 3.0
    x[0] = 0.0                          # a zero group: scale 1.0, codes 0
    if gsz >= 8 and G > 1:              # exact .5 quotients: half to even
        x[1, :8] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5,
                                 126.5], dtype=dtype)
        x[1, 8:] = x[1, 8:].clamp(-127, 127)
    before = quantize_rows.launches
    q, s = quantize_rows(x)
    rq, rs = quantize_rows_reference(x)
    torch.cuda.synchronize()
    assert quantize_rows.launches == before + 1
    assert torch.equal(q, rq) and torch.equal(s, rs)
    assert s[0].item() == 1.0 and not q[0].any()


# B9's vector body: group sizes 8, 128 and 4096 (the wire codec's), sizes
# past one chunk a lane that are not powers of two, and the widest groups of
# a warp's lanes (256) and past it (264); (offset elements into the buffer:
# 8 keeps a 16-byte boundary for both dtypes)
QUANT_VEC_CASES = [(G, gsz, off) for G, gsz in (
    (1, 8), (1000, 8), (64, 128), (4099, 128), (3, 4096), (37, 24), (9, 40),
    (33, 256), (5, 264)) for off in (0, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,gsz,offset", QUANT_VEC_CASES)
def test_quantize_vec_body_bit_equal(gen, dtype, G, gsz, offset):
    """The vector body against the plain version, bit for bit, with a zero
    group, exact .5 quotients, a NaN group, a group holding one NaN, an inf
    group and a -inf group."""
    from deepspeed_tpu_torch.ops.quant_cuda import (quant_body, quantize_rows,
                                                    quantize_rows_reference)

    buf = _randn(gen, (offset + G * gsz,), dtype) * 3.0
    x = buf[offset:].view(G, gsz)
    specials = [("zero", 0.0), ("nan", float("nan")), ("one_nan", None),
                ("inf", None), ("-inf", None)]
    for i, (kind, fill) in enumerate(specials[:G]):
        if fill is not None:
            x[i] = fill
        elif kind == "one_nan":
            x[i, gsz // 2] = float("nan")
        else:
            x[i, gsz - 1] = float(kind)
    if G > 6 and gsz >= 8:
        x[5, :8] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5,
                                 126.5], dtype=dtype)
        x[5, 8:] = x[5, 8:].clamp(-127, 127)
    assert quant_body(x) == "vec"
    before = dict(quantize_rows.body_launches)
    q, s = quantize_rows(x)
    rq, rs = quantize_rows_reference(x)
    torch.cuda.synchronize()
    assert quantize_rows.body_launches == {"vec": before["vec"] + 1,
                                           "scalar": before["scalar"]}
    assert torch.equal(q, rq) and _nan_equal(s, rs)
    assert s[0].item() == 1.0 and not q[0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,gsz,offset", [(17, 7, 0), (64, 33, 0),
                                          (64, 128, 1), (8, 4096, 3)])
def test_quantize_scalar_body_takes_odd_sizes_and_views(gen, dtype, G, gsz,
                                                        offset):
    """Group sizes off a multiple of 8, and views off a 16-byte boundary,
    take the scalar body: bit-equal too."""
    from deepspeed_tpu_torch.ops.quant_cuda import (quant_body, quantize_rows,
                                                    quantize_rows_reference)

    buf = _randn(gen, (offset + G * gsz,), dtype) * 3.0
    x = buf[offset:].view(G, gsz)
    x[1] = float("nan")
    x[2, 0] = float("inf")
    assert quant_body(x) == "scalar"
    before = dict(quantize_rows.body_launches)
    q, s = quantize_rows(x)
    rq, rs = quantize_rows_reference(x)
    torch.cuda.synchronize()
    assert quantize_rows.body_launches == {"vec": before["vec"],
                                           "scalar": before["scalar"] + 1}
    assert torch.equal(q, rq) and _nan_equal(s, rs)


# the fused K/V write: (rows a sequence, starts; None = a prompt from 0) over
# 4 sequences of 5 pages (capacity 5 * ps)
WRITE_KV_CASES = [
    (1, [0, 7, 79, 80]),            # decode: the last slot, then at capacity
    (1, [3, 100, 16, 33]),          # past capacity: dropped
    (9, [0, 9, 75, 80]),            # a chunk running past capacity
    (256, [0, 0, 0, 0]),            # a chunk past every table
    (16, None), (37, None), (1, None), (80, None),     # prompts, padded tails
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("rows,start", WRITE_KV_CASES)
def test_write_kv_quant_matches_plain(gen, dtype, D, rows, start):
    """One launch of the fused write against its plain version: the four
    page planes (codes and scales of K and V) bit for bit, whole, with a
    zero row, a NaN row and an inf row among the new ones."""
    from deepspeed_tpu_torch.inference.kernels import (
        write_kv_quant, write_kv_quant_reference)
    from deepspeed_tpu_torch.ops.quant_cuda import quantize_rows

    B, KV, ps, mp = 4, 8, 16, 5
    P = B * mp + 3
    perm = torch.randperm(P, generator=gen, device="cuda").int()
    table = perm[:B * mp].reshape(B, mp).contiguous()
    nk = _randn(gen, (B, rows, KV, D), dtype) * 3.0
    nv = _randn(gen, (B, rows, KV, D), dtype)
    nk[0, 0, 0] = 0.0
    nk[1, 0, 1] = float("nan")
    nv[2, 0, 2, 3] = float("inf")
    planes = [torch.randint(-127, 128, (KV, P, ps, D), generator=gen,
                            device="cuda", dtype=torch.int8),
              torch.rand((KV, P, ps, 1), generator=gen, device="cuda")]
    planes = [planes[0], planes[1], planes[0].flip(1).contiguous(),
              planes[1].flip(1).contiguous()]
    want = [p.clone() for p in planes]
    st = (None if start is None else
          torch.tensor(start, dtype=torch.int32, device="cuda"))
    before = dict(quantize_rows.body_launches)
    write_kv_quant(*planes, nk, nv, table, st, ps)
    write_kv_quant_reference(*want, nk, nv, table, st, ps)
    torch.cuda.synchronize()
    assert quantize_rows.body_launches == {"vec": before["vec"] + 1,
                                           "scalar": before["scalar"]}
    for got, ref in zip(planes, want):
        if got.dtype == torch.int8:
            assert torch.equal(got, ref)
        else:
            assert _nan_equal(got, ref)


def test_write_kv_quant_rejects_what_it_cannot_take(gen):
    from deepspeed_tpu_torch.inference.kernels import write_kv_quant

    kq = torch.zeros((2, 6, 4, 16), dtype=torch.int8, device="cuda")
    ks = torch.ones((2, 6, 4, 1), device="cuda")
    new = _randn(gen, (1, 3, 2, 16), torch.float32)
    table = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    st = torch.zeros((1,), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="int32"):
        write_kv_quant(kq, ks, kq, ks, new, new, table.long(), st, 4)
    with pytest.raises(ValueError, match="plane"):
        write_kv_quant(kq, ks.half(), kq, ks, new, new, table, st, 4)
    with pytest.raises(ValueError, match="pages"):
        write_kv_quant(kq, ks, kq, ks, new[..., :12], new[..., :12], table,
                       st, 4)
    with pytest.raises(ValueError, match="prompt"):
        write_kv_quant(kq, ks, kq, ks, torch.cat([new] * 3, 1),
                       torch.cat([new] * 3, 1), table, None, 4)


def test_quantize_nan_inf_and_strided_rows(gen):
    from deepspeed_tpu_torch.inference.kernels import quantize_kv_rows
    from deepspeed_tpu_torch.ops.quant_cuda import (quantize_rows,
                                                    quantize_rows_reference)

    x = _randn(gen, (6, 128), torch.float32)
    x[0, 3] = float("nan")
    x[1, 9] = float("inf")
    x[2, 0] = -float("inf")
    x[3] = float("nan")
    q, s = quantize_rows(x)
    rq, rs = quantize_rows_reference(x)
    torch.cuda.synchronize()
    assert torch.equal(q, rq) and _nan_equal(s, rs)
    assert not q[:4].any() and torch.isnan(s[[0, 3]]).all()
    # the decode writer's strided view [B, 1, KV, Dh] of [B, T, KV, Dh]
    k = _randn(gen, (4, 3, 2, 64), torch.bfloat16)
    kq, ks = quantize_kv_rows(k[:, 1:2])
    wq, ws = quantize_kv_rows(k[:, 1:2].contiguous(), force_reference=True)
    assert torch.equal(kq, wq) and torch.equal(ks, ws)


def test_quantize_offsets_past_int32(gen):
    """More elements than an int holds: the tail groups, past 2^31, are
    right (64-bit offsets)."""
    from deepspeed_tpu_torch.ops.quant_cuda import (quantize_rows,
                                                    quantize_rows_reference)

    G = (1 << 31) // 128 + 64
    x = torch.ones((G, 128), dtype=torch.bfloat16, device="cuda")
    tail = _randn(gen, (256, 128), torch.bfloat16)
    x[-256:] = tail
    q, s = quantize_rows(x)
    rq, rs = quantize_rows_reference(tail)
    hq, hs = quantize_rows_reference(x[:4])
    torch.cuda.synchronize()
    assert torch.equal(q[-256:], rq) and torch.equal(s[-256:], rs)
    assert torch.equal(q[:4], hq) and torch.equal(s[:4], hs)


@pytest.mark.parametrize("bits,symmetric", [(4, True), (2, True), (1, True),
                                            (8, False), (4, False)])
def test_plain_codecs_on_the_card_equal_the_host(gen, bits, symmetric):
    """The codecs that stay plain PyTorch on CUDA divide by tensors: codes,
    scales and zero-points on the card equal the host's bit for bit (a
    Python-scalar divisor would be a multiply by its reciprocal there,
    one ulp off on a few percent of 4096 groups)."""
    from deepspeed_tpu_torch.ops.quant import quantize

    x = _randn(gen, (4096, 128), torch.float32) * 3.0
    x[0] = 0.0
    got = quantize(x, bits=bits, num_groups=4096, symmetric=symmetric)
    want = quantize(x.cpu(), bits=bits, num_groups=4096, symmetric=symmetric)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("kind", ["e4m3", "e5m2"])
def test_fp8_on_the_card_equals_the_host(gen, kind):
    """``to_fp8``'s per-tensor scale and fp8 bits on the card equal the
    host's, over 256 tensors (256 scale divisions)."""
    from deepspeed_tpu_torch.ops.quant import to_fp8

    x = _randn(gen, (256, 64), torch.float32) * 5.0
    for row in x:
        q, s = to_fp8(row, kind)
        hq, hs = to_fp8(row.cpu(), kind)
        assert torch.equal(s.cpu(), hs)
        assert torch.equal(q.view(torch.uint8).cpu(), hq.view(torch.uint8))


def test_quantize_rejects_what_it_cannot_take(gen):
    from deepspeed_tpu_torch.ops.quant_cuda import quantize_rows

    with pytest.raises(ValueError, match="dtype"):
        quantize_rows(_randn(gen, (4, 8), torch.float16))
    with pytest.raises(ValueError, match=r"\[G, gsz\]"):
        quantize_rows(_randn(gen, (4, 8, 2), torch.float32))


@pytest.mark.parametrize("n", [1, 3, 1024, 1027, 4097])
@pytest.mark.parametrize("offset", [0, 1])
def test_env_probe_bit_equal_at_every_size_and_alignment(gen, n, offset):
    # offset 1: a contiguous view one float off 16-byte alignment, which
    # takes the scalar path; n % 4 != 0 leaves a scalar tail
    from deepspeed_tpu_torch import env_report

    x = torch.randn((n + offset,), generator=gen, device="cuda")[offset:]
    assert x.is_contiguous() and (x.data_ptr() % 16 == 0) == (offset == 0)
    before = env_report.env_probe.launches
    out = env_report.env_probe(x)
    torch.cuda.synchronize()
    assert torch.equal(out, 2 * x)
    assert env_report.env_probe.launches == before + 1


def test_env_probe_and_report_on_the_card(gen):
    from deepspeed_tpu_torch import env_report

    x = torch.arange(8 * 128, dtype=torch.float32, device="cuda").reshape(
        8, 128)
    before = env_report.env_probe.launches
    out = env_report.env_probe(x)
    torch.cuda.synchronize()
    assert torch.equal(out, 2 * x)
    assert env_report.env_probe.launches == before + 1
    r = env_report.report()
    assert r["ops"]["cuda probe"] == {"ok": True, "mode": "compiled",
                                      "error": None}
    assert r["backend"]["name"] == "cuda" and r["backend"]["devices"]


def _wgmma_llama(**kw):
    """A small Llama whose attention takes the flash kernels' tensor-core
    bodies (bf16, head_dim 128)."""
    from deepspeed_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=2,
                       n_kv_heads=1, ffn_dim=512, max_seq_len=256, **kw)


def _packed_llama_batch(seed, B=2, T=129, vocab=512):
    import numpy as np

    rng = np.random.default_rng(seed)
    seg = np.ones((B, T), np.int32)
    for b in range(B):
        seg[b, int(rng.integers(20, T - 20)):] = 2
        seg[b, T - 1 - 3 * b:] = 0
    return {"tokens": rng.integers(0, vocab, (B, T)).astype(np.int32),
            "segment_ids": seg}


def test_bf16_save_load_continue_on_the_card(gen, tmp_path):
    """save -> drop the engine -> load -> continue equals the uninterrupted
    run on the card, bit for bit (losses and every state leaf)."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch._tree import tree_leaves
    from deepspeed_tpu_torch.models.llama import loss_fn
    from deepspeed_tpu_torch.ops.adam_cuda import fused_adam
    from deepspeed_tpu_torch.weights import init_params

    cfg = _wgmma_llama()
    params = init_params(cfg, gen, device="cuda", dtype=torch.float32)
    conf = {"train_batch_size": 2, "gradient_accumulation_steps": 2,
            "gradient_clipping": 1.0, "bf16": {"enabled": True}}
    batches = [_packed_llama_batch(i) for i in range(4)]

    def engine():
        return initialize(loss_fn=loss_fn(cfg), params=params, config=conf,
                          optimizer=fused_adam(lr=1e-3, weight_decay=0.1))[0]

    ref = engine()
    want = [float(ref.train_batch(b)) for b in batches]
    first = engine()
    got = [float(first.train_batch(b)) for b in batches[:2]]
    first.save_checkpoint(str(tmp_path), async_save=True)
    first.wait_for_checkpoint()
    del first
    resumed = engine()
    resumed.load_checkpoint(str(tmp_path))
    got += [float(resumed.train_batch(b)) for b in batches[2:]]
    assert got == want
    assert resumed.state.step == ref.state.step == 4
    for a, b in zip(tree_leaves(resumed.state), tree_leaves(ref.state)):
        if torch.is_tensor(a):
            assert a.is_cuda and torch.equal(a, b)


def test_remat_full_with_flash_kernels_equals_no_remat(gen):
    """remat="full" re-runs B1 in the backward (twice the launches, all on
    the tensor-core body, segment ids set) and gives the gradients of
    remat="none", bit for bit: the recomputed forward is the same kernels
    on the same inputs."""
    from deepspeed_tpu_torch.models.llama import loss_fn
    from deepspeed_tpu_torch.ops.attention_cuda import (flash_bwd_dkv,
                                                        flash_bwd_dq,
                                                        flash_fwd)
    from deepspeed_tpu_torch.weights import init_params

    base = init_params(_wgmma_llama(), gen, device="cuda")
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _packed_llama_batch(7).items()}
    out = {}
    for remat in ("none", "full"):
        cfg = _wgmma_llama(remat=remat)
        params = {k: ({n: w.clone().requires_grad_(True)
                       for n, w in v.items()} if isinstance(v, dict)
                      else v.clone().requires_grad_(True))
                  for k, v in base.items()}
        for f in (flash_fwd, flash_bwd_dq, flash_bwd_dkv):
            f.launches = 0
            f.body_launches = {b: 0 for b in f.body_launches}
        loss = loss_fn(cfg)(params, batch)
        loss.backward()
        torch.cuda.synchronize()
        grads = [params["embed"].grad, params["lm_head"].grad,
                 params["final_norm"].grad,
                 *(params["blocks"][n].grad for n in sorted(params["blocks"]))]
        out[remat] = (loss.item(), grads,
                      {f.__name__: dict(f.body_launches)
                       for f in (flash_fwd, flash_bwd_dq, flash_bwd_dkv)})
    (l0, g0, n0), (l1, g1, n1) = out["none"], out["full"]
    assert l0 == l1
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    L = _wgmma_llama().n_layers
    assert n0["flash_fwd"] == {"wgmma": L, "scalar": 0}
    assert n1["flash_fwd"] == {"wgmma": 2 * L, "scalar": 0}
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert n0[name] == n1[name] == {"wgmma": L, "scalar": 0}


# ------------------------------------------------------ the GPT-2 shapes
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 8])
def test_greedy_gpt2_vocab_misaligned_rows(gen, dtype, B):
    """B6 at GPT-2's vocabulary (V = 50257): rows taken as ``logits[:, -1]``
    of a [B, 3, V] tensor, so each row starts at its own offset from a
    16-byte boundary (3 V elements apart), with ties planted on both sides
    of every span edge of each row's own split."""
    from deepspeed_tpu_torch.ops.sampling_cuda import (fused_greedy_rows,
                                                       greedy_split_plan)

    V = 50257
    x = _randn(gen, (B, 3, V), dtype)
    x[:, 0] = 99.0                      # the other positions never count
    last = x[:, -1]
    assert last.stride(0) == 3 * V
    fused_greedy_rows.body_launches = dict.fromkeys(
        fused_greedy_rows.body_launches, 0)
    _greedy_exact(last)
    firsts = []
    width = 16 // x.element_size()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    for b in range(B):
        head = (16 - last[b].data_ptr() % 16) % 16 // x.element_size()
        _, edges = greedy_split_plan(B, V, sms, width, head)
        inner = [e for e in edges[1:-1] if 0 < e < V]
        assert inner
        last[b, inner] = 40.0
        last[b, [e - 1 for e in inner]] = 40.0
        firsts.append(inner[0] - 1)
    got = _greedy_exact(last)
    assert got.tolist() == firsts
    assert fused_greedy_rows.body_launches == {"cluster": 2, "row": 0}


def _mha_paged_case(gen, H, D, C, ps=16, lens=(1, 15, 16, 17, 255, 511, 769,
                                                1024)):
    """GPT-2's paged shapes: B = 8 rows, H = KV heads (G = 1), a shuffled
    table; decode (C = 1: the row's last position) or a C-token chunk after
    each row's history.  Returns q, the bf16 pools, the table, the starts."""
    B = len(lens)
    starts = [n - 1 for n in lens]
    mp = -(-(max(starts) + C) // ps)
    P = B * mp + 1
    perm = torch.randperm(P - 1, generator=gen, device="cuda").int()
    table = perm[:B * mp].view(B, mp).contiguous()
    kp = _randn(gen, (H, P, ps, D), torch.bfloat16)
    vp = _randn(gen, (H, P, ps, D), torch.bfloat16)
    q = _randn(gen, (B, C, H, D), torch.bfloat16)
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    return q, kp, vp, table, st


@pytest.mark.parametrize("H,D", [(12, 64), (16, 128)])
@pytest.mark.parametrize("C", [1, 256])
def test_paged_sm90_body_full_multi_head(gen, H, D, C):
    """B5's Hopper body at G = H / KV = 1 (GPT-2 small and 1.3B), decode and
    a C = 256 chunk (two items of 128 flattened rows each), against the
    plain version at the smoke's gates (PAGED_DECODE_TOL 4e-3,
    PAGED_CHUNK_TOL 1e-2)."""
    from deepspeed_tpu_torch.inference.paged_attention_cuda import (
        paged_body, paged_chunk_attention, paged_chunk_attention_reference)

    q, kp, vp, table, st = _mha_paged_case(gen, H, D, C)
    assert paged_body(q) == "sm90"
    before = dict(paged_chunk_attention.body_launches)
    out = paged_chunk_attention(q, kp, vp, table, st)
    ref = paged_chunk_attention_reference(q, kp, vp, table, st)
    torch.cuda.synchronize()
    assert paged_chunk_attention.body_launches["sm90"] == before["sm90"] + 1
    assert torch.isfinite(out).all()
    tol = 4e-3 if C == 1 else 1e-2
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("D", [64, 128])
def test_flash_full_multi_head_causal(gen, D):
    """B1-B3 at H = KV (one query head per kv head), causal, T = 1024, on
    the tensor-core bodies, against the plain versions (forward at the
    file's bf16 bound, the backward's three gradients relative to their
    largest value at it too)."""
    from deepspeed_tpu_torch.ops.attention_cuda import (
        flash_bwd, flash_bwd_dkv, flash_bwd_dq, flash_bwd_reference,
        flash_fwd, flash_fwd_reference)

    H = 12 if D == 64 else 16
    dt = torch.bfloat16
    q, k, v, do = (_randn(gen, (2, 1024, H, D), dt) for _ in range(4))
    before = [dict(f.body_launches)
              for f in (flash_fwd, flash_bwd_dq, flash_bwd_dkv)]
    o, lse = flash_fwd(q, k, v, causal=True)
    ro, rlse = flash_fwd_reference(q, k, v, causal=True)
    got = flash_bwd(q, k, v, o, lse, do, None, True)
    want = flash_bwd_reference(q, k, v, o, lse, do, None, True)
    torch.cuda.synchronize()
    for f, b in zip((flash_fwd, flash_bwd_dq, flash_bwd_dkv), before):
        assert f.body_launches["wgmma"] == b["wgmma"] + 1
        assert f.body_launches["scalar"] == b["scalar"]
    assert (o.float() - ro.float()).abs().max().item() <= TOL[dt]
    assert (lse - rlse).abs().max().item() <= 1e-3
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(g, w) <= TOL[dt], name


def test_f32_matmul_tied_head_takes_the_transposed_view(gen):
    """The GPT-2 head ``f32_matmul(x, wte.T)`` at 1.3B's widths: no copy of
    the 206 MB table (the peak grows by less than a tenth of it), and the
    values of the upcast product at test_f32_matmul_on_the_card's 1e-5."""
    from deepspeed_tpu_torch.ops.losses import f32_matmul

    wte = _randn(gen, (50257, 2048), torch.bfloat16)
    x = _randn(gen, (8, 2048), torch.bfloat16)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = f32_matmul(x, wte.T)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert got.shape == (8, 50257) and got.dtype == torch.float32
    assert extra < wte.numel() * wte.element_size() // 10, extra
    assert _rel_err(got, x.float() @ wte.float().T) <= 1e-5


def _gpt2_card(remat):
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config

    return GPT2Config(vocab_size=512, dim=1024, n_layers=4, n_heads=16,
                      max_seq_len=512, remat=remat)


@pytest.mark.parametrize("name", ["offload_attn", "offload_dots_no_batch"])
def test_offload_remat_on_the_card(gen, name, monkeypatch):
    """The offload policies on bf16 GPT-2 blocks (head_dim 64, flash on the
    tensor-core bodies): gradients bit-equal to the on-device twin's, the
    moved bytes those the twin keeps, and a lower peak: the named (or
    product) tensors sit in pinned host memory between the forward and the
    backward, copied on the offload stream.  Every copy back to the card is
    read: no prefetched buffer is dropped unread."""
    import numpy as np

    from deepspeed_tpu_torch import remat
    from deepspeed_tpu_torch.models.gpt2 import loss_fn
    from deepspeed_tpu_torch.weights import init_params

    calls = {"_copy_back": 0, "load": 0}
    for method in calls:
        def counted(self, _f=getattr(remat._Offloaded, method), _m=method):
            calls[_m] += 1
            return _f(self)
        monkeypatch.setattr(remat._Offloaded, method, counted)

    base = init_params(_gpt2_card("none"), gen, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, 512, (4, 513))).cuda()
    out = {}
    for policy in (remat.OFFLOAD[name], name):
        params = {k: ({n: w.clone().requires_grad_(True)
                       for n, w in v.items()} if isinstance(v, dict)
                      else v.clone().requires_grad_(True))
                  for k, v in base.items()}
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        remat.offload.reset()
        loss = loss_fn(_gpt2_card(policy))(params, {"tokens": toks})
        moved = remat.offload.bytes
        loss.backward()
        torch.cuda.synchronize()
        grads = [params["wte"].grad, params["wpe"].grad,
                 *(params["blocks"][n].grad for n in sorted(params["blocks"]))]
        out[policy] = (loss.item(), grads, moved,
                       torch.cuda.max_memory_allocated() - start)
    (l0, g0, m0, p0), (l1, g1, m1, p1) = out[remat.OFFLOAD[name]], out[name]
    assert l0 == l1 and m0 == 0
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    per_layer = (1024 + 4096) if name == "offload_attn" else \
        (3 * 1024 + 1024 + 4 * 1024 + 1024)
    assert m1 == 4 * 4 * 512 * per_layer * 2          # layers, B, T, bf16
    assert p0 - p1 >= m1 // 2, (p0, p1, m1)
    assert 0 < calls["load"] == calls["_copy_back"], calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 8])
def test_greedy_mixtral_vocab_rows(gen, dtype, B):
    """B6 at Mixtral's vocabulary (V = 32000) on ``logits[:, -1]`` rows of
    a [B, 2, V] tensor, ties planted across the row: exact against the
    plain version and ``torch.argmax``, on the cluster body."""
    from deepspeed_tpu_torch.ops.sampling_cuda import fused_greedy_rows

    V = 32000
    last = _randn(gen, (B, 2, V), dtype)[:, -1]
    for b in range(B):
        last[b, [b, V // 3 + b, V // 2, V - 1 - b]] = 30.0
    fused_greedy_rows.body_launches = dict.fromkeys(
        fused_greedy_rows.body_launches, 0)
    got = _greedy_exact(last)
    assert got.tolist() == list(range(B))
    assert fused_greedy_rows.body_launches == {"cluster": 1, "row": 0}


def test_quantize_mixtral_expert_slice_bit_equal(gen):
    """B9 on one layer of a Mixtral-8x7B expert stack, ``w1[l]`` = [8, 4096,
    14336] bf16 (470 M elements, groups of 128), as ``init_quantized_params``
    quantizes it: the vector body, bit for bit against the plain version."""
    from deepspeed_tpu_torch.ops.quant_cuda import (quant_body, quantize_rows,
                                                    quantize_rows_reference)

    x = _randn(gen, (8 * 4096 * 14336 // 128, 128), torch.bfloat16)
    assert quant_body(x) == "vec"
    before = dict(quantize_rows.body_launches)
    q, s = quantize_rows(x)
    torch.cuda.synchronize()
    assert quantize_rows.body_launches["vec"] == before["vec"] + 1
    for lo in range(0, x.shape[0], 1 << 20):       # the plain version, in
        rq, rs = quantize_rows_reference(x[lo:lo + (1 << 20)])   # slices
        assert torch.equal(q[lo:lo + (1 << 20)], rq)
        assert torch.equal(s[lo:lo + (1 << 20)], rs)


@pytest.mark.parametrize("k", [1, 2])
def test_capacity_gating_on_the_card_equals_the_cpu(gen, k):
    """The top-k gate at the 8x7B training shape (4 x 1024 tokens, 8
    experts, capacity factor 1.25: C = 1280, some tokens dropped): the
    dispatch equal to the CPU's, the combine and the losses at 1e-6."""
    from deepspeed_tpu_torch.parallel.moe import capacity, top_k_gating

    N, E = 4096, 8
    logits = torch.randn((N, E), generator=gen, device="cuda") * 2.0
    logits[:, 0] += 1.0                 # a skew, so some expert overflows
    cap = capacity(N, E, k, 1.25)
    got = top_k_gating(logits, k, cap)
    want = top_k_gating(logits.cpu(), k, cap)
    assert torch.equal(got.dispatch.cpu(), want.dispatch)
    assert want.dispatch.sum().item() < N * k          # drops happened
    for name in ("combine", "aux_loss", "z_loss", "expert_load"):
        torch.testing.assert_close(getattr(got, name).cpu(),
                                   getattr(want, name), rtol=1e-6,
                                   atol=1e-6, msg=name)


def _mixtral_card(remat):
    from deepspeed_tpu_torch.models.mixtral import MixtralConfig

    return MixtralConfig(vocab_size=512, dim=1024, n_layers=2, n_heads=8,
                         n_kv_heads=2, ffn_dim=1024, num_experts=4,
                         max_seq_len=512, remat=remat)


def test_mixtral_remat_on_the_card(gen):
    """bf16 Mixtral blocks (head_dim 128, flash on the tensor-core bodies,
    the capacity gate): ``save_attn``, ``offload_attn`` and
    ``save_dots_no_batch`` give the gradients and aux of ``none`` bit for
    bit, and ``offload_attn`` moves ``attn_out`` of each layer to host."""
    import numpy as np

    from deepspeed_tpu_torch import remat
    from deepspeed_tpu_torch.models.mixtral import loss_fn
    from deepspeed_tpu_torch.weights import init_params

    base = init_params(_mixtral_card("none"), gen, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, 512, (2, 257))).cuda()
    out = {}
    for policy in ("none", "save_attn", "offload_attn",
                   "save_dots_no_batch"):
        params = {k: ({n: w.clone().requires_grad_(True)
                       for n, w in v.items()} if isinstance(v, dict)
                      else v.clone().requires_grad_(True))
                  for k, v in base.items()}
        remat.offload.reset()
        loss, aux = loss_fn(_mixtral_card(policy))(params, {"tokens": toks})
        moved = remat.offload.bytes
        loss.backward()
        torch.cuda.synchronize()
        grads = [params["embed"].grad, params["lm_head"].grad,
                 *(params["blocks"][n].grad for n in sorted(params["blocks"]))]
        out[policy] = (loss.item(), aux, grads, moved)
    l0, a0, g0, _ = out["none"]
    for policy in ("save_attn", "offload_attn", "save_dots_no_batch"):
        l1, a1, g1, moved = out[policy]
        assert l1 == l0, policy
        for name in a0:
            assert torch.equal(a1[name], a0[name]), (policy, name)
        for a, b in zip(g0, g1):
            assert torch.equal(a, b), policy
        assert moved == (2 * 2 * 256 * 1024 * 2
                         if policy == "offload_attn" else 0), policy
