"""Mixtral of the port against the JAX model on ``MixtralConfig.tiny()``
(2 layers, dim 32, 4 experts, top-2) with the same weights through
``from_jax_params``.

Tolerances: f32 logits and aux at 1e-4 (test_torch_llama.py's: the same
operations summed in another order over two layers); the loss at 1e-5 and
every leaf's gradient at 1e-4 relative / 1e-6 absolute
(test_torch_remat.py's); bf16 logits at 0.06 (test_torch_llama.py's bf16
bound: 8 mantissa bits per rounding, logits of a few units, two layers) up
to a row's first token whose top-2 routing flipped between the frameworks
(a bf16 near-tie, ROADMAP C-w2).
The int8 forward runs bf16 activations on both sides (the embedding is
quantized, so the residual stream is bfloat16, as ``rms_norm`` keeps x's
dtype), and is held to the same bf16 bound.  Every remat policy gives the
gradients of ``remat="none"`` exactly: the recompute runs the same
operations on the same inputs.  The paged forwards run JAX's
``paged_kernel="xla"`` arm.
"""

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import quantized as jqz
from deepspeed_tpu.inference.generation import KVCache as JDense
from deepspeed_tpu.inference.kernels import PagedKVCache as JCache
from deepspeed_tpu.models import mixtral as jm
from deepspeed_tpu_torch import remat as tremat
from deepspeed_tpu_torch._tree import tree_leaves_with_path
from deepspeed_tpu_torch.inference import quantized as tqz
from deepspeed_tpu_torch.inference.generation import KVCache as TDense
from deepspeed_tpu_torch.inference.kernels import PagedKVCache as TCache
from deepspeed_tpu_torch.inference.serving import MIXTRAL_INT8_SKIP
from deepspeed_tpu_torch.models import mixtral as tm
from deepspeed_tpu_torch.weights import (from_jax_params, init_params,
                                         init_quantized_params)

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_ATOL = 0.06
ALL_POLICIES = tremat.POLICIES + tuple(tremat.OFFLOAD)
AUX = ("moe_aux_loss", "moe_z_loss", "moe_expert_load")


@pytest.fixture(scope="module")
def model():
    cfg = jm.MixtralConfig.tiny()
    jp = jax.device_get(jm.init_params(jax.random.PRNGKey(0), cfg))
    # norm gains off one, so their gradients differ leaf by leaf
    rng = np.random.default_rng(9)
    for name in ("attn_norm", "mlp_norm"):
        leaf = jp["blocks"][name]
        jp["blocks"][name] = (leaf + rng.normal(0, 0.1, leaf.shape)).astype(
            np.float32)
    tp = from_jax_params(jp, device="cpu")
    return cfg, tm.MixtralConfig.tiny(), jp, tp


def _tokens(B, T, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, T)).astype(
        np.int32)


def _aux_close(got, want, **tol):
    assert set(got) == set(AUX) == set(want)
    for name in AUX:
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   np.asarray(want[name]), err_msg=name,
                                   **tol)


def test_bridge_is_a_plain_copy(model):
    _, _, jp, tp = model
    assert set(tp) == set(jp) and set(tp["blocks"]) == set(jp["blocks"])
    for path, leaf in tree_leaves_with_path(tp):
        want = jp
        for key in path.split("/"):
            want = want[key]
        assert leaf.dtype == torch.float32
        np.testing.assert_array_equal(leaf.numpy(), want)
    assert tuple(tp["blocks"]["w1"].shape) == (2, 4, 32, 128)
    assert tuple(tp["blocks"]["gate"].shape) == (2, 32, 4)


def test_config_presets_and_param_count():
    for preset in ("tiny", "mixtral_8x7b"):
        a = getattr(jm.MixtralConfig, preset)()
        b = getattr(tm.MixtralConfig, preset)()
        assert dataclasses.asdict(b) == dataclasses.asdict(a)
        assert b.head_dim == a.head_dim
        assert dataclasses.asdict(b.moe_config()) == dataclasses.asdict(
            a.moe_config())
        # the port's LlamaConfig carries the sparse-attention block too
        want = dataclasses.asdict(a.llama_view())
        assert want["sparse_config"] is None
        assert dataclasses.asdict(b.llama_view()) == want
    big = tm.MixtralConfig.mixtral_8x7b()
    assert tm.param_count(big) == 46_702_792_704
    for cfg in (big, tm.MixtralConfig(), tm.MixtralConfig.tiny(),
                tm.MixtralConfig.tiny(num_experts=8, top_k=1, n_layers=3)):
        jcfg = jm.MixtralConfig(**dataclasses.asdict(cfg))
        assert tm.param_count(cfg) == jm.param_count(jcfg)
    assert tm.MixtralConfig(dim=96).ffn_dim == jm.MixtralConfig(dim=96).ffn_dim
    with pytest.raises(ValueError, match="remat"):
        tm.MixtralConfig.tiny(remat="bogus")
    # ring, ulysses and sparse attention are ported; llama_view passes
    # attn_impl on, as JAX's does, and an unknown one raises
    assert tm.MixtralConfig.tiny(attn_impl="ring").attn_impl == "ring"
    assert tm.MixtralConfig.tiny(attn_impl="sparse").llama_view() \
        .attn_impl == "sparse"
    with pytest.raises(NotImplementedError, match="attn_impl"):
        tm.MixtralConfig.tiny(attn_impl="bogus")
    assert tm.MixtralConfig.tiny(attn_impl="reference").llama_view() \
        .attn_impl == "reference"
    with pytest.raises(ValueError, match="divide"):
        tm.MixtralConfig.tiny(n_kv_heads=3)


def test_forward_logits_and_aux(model):
    cfg, tcfg, jp, tp = model
    toks = _tokens(2, 13)
    want, waux = jm.forward(jp, jnp.asarray(toks), cfg)
    got, gaux = tm.forward(tp, torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 13, 256)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    _aux_close(gaux, waux, **TOL)
    assert gaux["moe_expert_load"].shape == (4,)
    # each layer dispatches at most k tokens a token: the mean load is at
    # most k (drops lower it)
    assert 0 < gaux["moe_expert_load"].sum().item() <= 2.0 + 1e-6


def test_forward_eval_logits(model):
    cfg, tcfg, jp, tp = model
    toks = _tokens(2, 13, seed=1)
    want = np.asarray(jm.forward_eval(jp, jnp.asarray(toks), cfg))
    got = tm.forward_eval(tp, torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_top_k_order_is_jax_top_k():
    lg = np.random.default_rng(3).normal(size=(40, 8)).astype(np.float32)
    lg[0, [1, 5]] = 7.0                      # tie at the top
    lg[1, [0, 2, 6]] = 3.0
    lg[1, 4] = 5.0                           # tie for the second choice
    lg[2, :] = 0.25                          # all tied
    want = np.asarray(jax.lax.top_k(jnp.asarray(lg), 2)[1])
    got = tm._top_k(torch.from_numpy(lg), 2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dense_moe_ffn_equal_to_jax(model):
    cfg, tcfg, jp, tp = model
    x = np.random.default_rng(4).normal(size=(2, 7, 32)).astype(np.float32)
    lp = {k: v[1] for k, v in jp["blocks"].items()}
    want = np.asarray(jm._moe_ffn_dense(cfg, jnp.asarray(x),
                                        jax.tree.map(jnp.asarray, lp)))
    got = tm._moe_ffn_dense(tcfg, torch.from_numpy(x),
                            {k: v[1] for k, v in tp["blocks"].items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_forward_with_cache_prefill_then_decode(model):
    cfg, tcfg, jp, tp = model
    jc = JDense.alloc(cfg.n_layers, 2, 24, cfg.n_kv_heads, cfg.head_dim,
                      dtype=jnp.float32)
    tc = TDense.alloc(cfg.n_layers, 2, 24, cfg.n_kv_heads, cfg.head_dim,
                      dtype=torch.float32, device="cpu")
    for i, T in enumerate((9, 1, 1, 3)):
        toks = _tokens(2, T, seed=30 + i)
        want, jc = jm.forward_with_cache(jp, jnp.asarray(toks), cfg, jc)
        got, tc = tm.forward_with_cache(tp, torch.from_numpy(toks), tcfg, tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert tc.length == int(jc.length)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **TOL)


def _caches(cfg, B, ps=4, max_seq=48):
    mp = -(-max_seq // ps)
    j = JCache.alloc(cfg.n_layers, cfg.n_kv_heads, B * mp + 1, ps,
                     cfg.head_dim, B, max_seq, dtype=jnp.float32)
    t = TCache.alloc(cfg.n_layers, cfg.n_kv_heads, B * mp + 1, ps,
                     cfg.head_dim, B, max_seq, dtype=torch.float32,
                     device="cpu")
    return j, t


def test_forward_paged_whole_chunked_and_decode(model):
    """Whole-prompt prefill, decode steps and a split-fuse chunk against
    JAX's ``paged_kernel="xla"`` arm; the cache and frontiers too."""
    cfg, tcfg, jp, tp = model
    jc, tc = _caches(cfg, B=2)

    def both(toks, cont=False):
        nonlocal jc, tc
        want, jc = jm.forward_paged(jp, jnp.asarray(toks), cfg, jc,
                                    continuation=cont, tp=False,
                                    paged_kernel="xla")
        got, tc = tm.forward_paged(tp, torch.from_numpy(toks), tcfg, tc,
                                   continuation=cont)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    both(_tokens(2, 9, seed=1))
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
    for i in range(3):
        both(_tokens(2, 1, seed=10 + i))
    both(_tokens(2, 6, seed=20), cont=True)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **TOL)
    np.testing.assert_array_equal(tc.seq_lens.numpy(),
                                  np.asarray(jc.seq_lens))


def test_forward_paged_chunked_prefill_equals_forward_eval(model):
    _, tcfg, _, tp = model
    toks = _tokens(1, 20, seed=2)
    _, tc = _caches(tcfg, B=1)
    out = []
    for lo in range(0, 20, 8):
        logits, tc = tm.forward_paged(tp, torch.from_numpy(toks[:, lo:lo + 8]),
                                      tcfg, tc, continuation=True)
        out.append(logits)
    dense = tm.forward_eval(tp, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(torch.cat(out, 1).numpy(), dense.numpy(),
                               **TOL)


def _segments(B=2, T=17):
    seg = np.ones((B, T), np.int32)
    seg[0, 7:] = 2
    seg[1, T - 3:] = 0
    return seg


def test_packed_segments_equal_to_jax_and_isolate_documents(model):
    """``segment_ids`` against JAX; and with capacity for every token (no
    drop, so each token's routing is its own), the second document's
    logits do not move when the first one's tokens change."""
    cfg, tcfg, jp, tp = model
    toks, seg = _tokens(2, 17, seed=6), _segments()
    want, waux = jm.forward(jp, jnp.asarray(toks), cfg,
                            segment_ids=jnp.asarray(seg))
    got, gaux = tm.forward(tp, torch.from_numpy(toks), tcfg,
                           segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    _aux_close(gaux, waux, **TOL)
    roomy = tm.MixtralConfig.tiny(capacity_factor=4.0)
    other = toks.copy()
    other[0, :7] = (other[0, :7] + 1) % 256
    a, _ = tm.forward(tp, torch.from_numpy(toks), roomy,
                      segment_ids=torch.from_numpy(seg))
    b, _ = tm.forward(tp, torch.from_numpy(other), roomy,
                      segment_ids=torch.from_numpy(seg))
    torch.testing.assert_close(b[0, 7:], a[0, 7:], rtol=0, atol=1e-6)
    assert not torch.allclose(b[0, :7], a[0, :7])


def test_int8_forward_close_to_jax_quantized_forward(model, monkeypatch):
    """The serving engine's int8 tree (router and norm gains exact):
    ``forward_eval`` and ``forward_paged`` dequantize one layer at a time
    and meet JAX's ``quantized_apply`` of the same forward, which
    dequantizes the whole tree; the router stays f32.  The residual stream
    is bf16, so a top-2 choice that JAX makes by less than the two
    frameworks' router-logit gap is a near-tie (ROADMAP C-w2 / C-f10):
    each row is held to the bf16 bound up to its first such token, and
    those tokens must be rare."""
    cfg, tcfg, jp, _ = model
    jqp = jqz.quantize_params(jax.tree.map(jnp.asarray, jp),
                              skip_paths=MIXTRAL_INT8_SKIP)
    tqp = from_jax_params(jax.device_get(jqp), device="cpu")
    assert not isinstance(tqp["blocks"]["gate"], tqz.QuantizedTensor)
    assert isinstance(tqp["blocks"]["w1"], tqz.QuantizedTensor)
    B, T = 2, 11
    toks = _tokens(B, T, seed=7)
    want = np.asarray(jqz.quantized_apply(
        lambda p, t: jm.forward_eval(p, t, cfg))(jqp, jnp.asarray(toks)))
    picked = []
    top_k = tm._top_k
    monkeypatch.setattr(tm, "_top_k", lambda lg, k: picked.append(
        lg.detach().clone()) or top_k(lg, k))
    got = tm.forward_eval(tqp, torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.float32
    upto = _upto_first_tie(jqz.dequantize_params(jqp), toks, cfg,
                           torch.stack(picked[:cfg.n_layers]).numpy())
    _close_upto(got.numpy(), want, upto)
    # per-layer dequantization == the whole tree's, bit for bit
    whole = tm.forward_eval(tqz.dequantize_params(tqp),
                            torch.from_numpy(toks), tcfg)
    assert torch.equal(got, whole)
    jc, tc = _caches(cfg, B=2)
    jstep = jqz.quantized_apply(
        lambda p, t, c: jm.forward_paged(p, t, cfg, c, tp=False,
                                         paged_kernel="xla"))
    want, jc = jstep(jqp, jnp.asarray(toks), jc)
    got, tc = tm.forward_paged(tqp, torch.from_numpy(toks), tcfg, tc)
    _close_upto(got.numpy(), np.asarray(want), upto)


def _jax_router_logits(jp, toks, cfg):
    """The f32 router logits of JAX's ``forward_eval``, its layer loop
    unrolled: [L, B * T, E]."""
    from deepspeed_tpu.models import llama as jl

    lcfg = cfg.llama_view()
    B, T = toks.shape
    x = jp["embed"][jnp.asarray(toks)]
    cos, sin = jl.rope_tables(lcfg, jnp.arange(T, dtype=jnp.int32))
    logits = []
    for l in range(cfg.n_layers):
        lp = jax.tree.map(lambda a: a[l], jp["blocks"])
        x = jm._attn_block(cfg, lcfg, x, lp, cos, sin)
        h = jl.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        logits.append(np.asarray(h.reshape(B * T, -1).astype(jnp.float32)
                                 @ lp["gate"].astype(jnp.float32)))
        x = x + jm._moe_ffn_dense(cfg, h, lp)
    return np.stack(logits)


def _upto_first_tie(jp, toks, cfg, port_logits):
    """Per row, the number of leading tokens compared: up to the first
    token that any layer routes by a margin (the k-th minus the (k+1)-th
    router logit, in JAX's run) below twice the largest gap between the
    two frameworks' router logits in this run.  A choice made by more than
    that cannot flip; one made by less is a near-tie (C-w2), which moves
    its token and, through causal attention, every later one.  Asserts
    that such tokens are rare and prints their margins."""
    B, T = toks.shape
    jlog = _jax_router_logits(jp, toks, cfg)
    bound = 2 * float(np.abs(port_logits - jlog).max())
    top = np.sort(jlog, -1)[..., ::-1]
    margin = top[..., cfg.top_k - 1] - top[..., cfg.top_k]      # [L, B*T]
    tied = (margin < bound).reshape(cfg.n_layers, B, T)
    ties = [(int(l), int(b), int(t), float(margin[l, b * T + t]))
            for l, b, t in np.argwhere(tied)]
    print(f"router tie bound {bound:.3g}; near-ties (layer, row, token, "
          f"margin): {ties}")
    assert tied.sum() <= tied.size // 16, tied.sum()
    upto = []
    for b in range(B):
        first = np.flatnonzero(tied[:, b].any(0))
        upto.append(int(first[0]) if len(first) else T)
    assert sum(upto) >= B * T // 2, upto
    return upto


def _close_upto(got, want, upto):
    for b, n in enumerate(upto):
        np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=0,
                                   atol=BF16_ATOL)


def _jax_routes(jp, toks, cfg):
    """The top-k experts JAX's ``forward_eval`` picks for every (layer,
    token): its layer loop unrolled, [L, B, T, k]."""
    from deepspeed_tpu.models import llama as jl

    lcfg = cfg.llama_view()
    B, T = toks.shape
    x = jp["embed"][jnp.asarray(toks)]
    cos, sin = jl.rope_tables(lcfg, jnp.arange(T, dtype=jnp.int32))
    routes = []
    for l in range(cfg.n_layers):
        lp = jax.tree.map(lambda a: a[l], jp["blocks"])
        x = jm._attn_block(cfg, lcfg, x, lp, cos, sin)
        h = jl.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        logits = h.reshape(B * T, -1).astype(jnp.float32) @ lp["gate"].astype(
            jnp.float32)
        routes.append(np.asarray(jax.lax.top_k(logits, cfg.top_k)[1]))
        x = x + jm._moe_ffn_dense(cfg, h, lp)
    return np.stack(routes).reshape(cfg.n_layers, B, T, cfg.top_k)


def test_bf16_logits_close_to_jax_bf16(model, monkeypatch):
    """bf16 weights and activations round at other places in the two
    frameworks, and a near-tied top-2 choice can then flip (ROADMAP C-w2),
    which moves that token's output, and through causal attention every
    later token's, by O(1).  So the logits are held to the bf16 bound up
    to each row's first token routed differently in any layer, and such
    tokens must be rare."""
    cfg, tcfg, jp, _ = model
    jp16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jp)
    tp16 = from_jax_params(jax.device_get(jp16), device="cpu")
    toks = _tokens(4, 16, seed=3)
    want = np.asarray(jm.forward_eval(jp16, jnp.asarray(toks), cfg))
    picked = []
    top_k = tm._top_k
    monkeypatch.setattr(tm, "_top_k", lambda lg, k: picked.append(
        top_k(lg, k)) or picked[-1])
    got = tm.forward_eval(tp16, torch.from_numpy(toks), tcfg).numpy()
    assert got.dtype == np.float32
    routes = torch.stack(picked).reshape(cfg.n_layers, 4, 16, 2).numpy()
    jroutes = _jax_routes(jp16, toks, cfg)
    differ = (np.sort(routes, -1) != np.sort(jroutes, -1)).any(-1)  # L,B,T
    assert differ.sum() <= differ.size // 16, differ.sum()
    compared = 0
    for b in range(4):
        flips = np.flatnonzero(differ[:, b].any(0))
        upto = flips[0] if len(flips) else 16
        np.testing.assert_allclose(got[b, :upto], want[b, :upto], rtol=0,
                                   atol=BF16_ATOL)
        compared += upto
    assert compared >= 32, compared


def _grads(tp, batch, remat="none"):
    tp = {k: ({n: w.detach().clone().requires_grad_(True)
               for n, w in v.items()} if isinstance(v, dict)
              else v.detach().clone().requires_grad_(True))
          for k, v in tp.items()}
    tremat.offload.reset()
    loss, aux = tm.loss_fn(tm.MixtralConfig.tiny(remat=remat))(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    moved = (tremat.offload.tensors, tremat.offload.bytes)
    loss.backward()
    return loss.item(), aux, \
        {p: t.grad for p, t in tree_leaves_with_path(tp)}, moved


def _batch(seed=4, masked=False):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, 256, (2, 18)).astype(np.int32)}
    if masked:
        batch["segment_ids"] = _segments(2, 18)
        batch["loss_mask"] = (rng.random((2, 18)) > 0.2).astype(np.int32)
    return batch


@pytest.mark.parametrize("masked", [False, True])
def test_loss_aux_and_gradients_of_every_leaf(model, masked):
    cfg, _, jp, tp = model
    batch = _batch(masked=masked)
    (jloss, jaux), jgrads = jax.value_and_grad(jm.loss_fn(cfg), has_aux=True)(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, batch))
    loss, aux, got, _ = _grads(tp, batch)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    assert set(aux) == {"lm_loss", *AUX} == set(jaux)
    for name in aux:
        np.testing.assert_allclose(aux[name].detach().numpy(),
                                   np.asarray(jaux[name]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    want = {"/".join(str(k.key) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert got.keys() == want.keys() and len(got) == 13
    for path, g in got.items():
        assert np.abs(g.numpy()).max() > 0, path
        np.testing.assert_allclose(g.numpy(), want[path], rtol=1e-4,
                                   atol=1e-6, err_msg=path)


@pytest.mark.parametrize("remat", [p for p in ALL_POLICIES if p != "none"])
def test_every_remat_policy_gives_the_gradients_of_none(model, remat):
    _, _, _, tp = model
    batch = _batch(seed=5, masked=True)
    base_loss, base_aux, base, _ = _grads(tp, batch)
    loss, aux, got, _ = _grads(tp, batch, remat)
    assert loss == base_loss
    for name in aux:
        assert torch.equal(aux[name], base_aux[name]), name
    for path, g in got.items():
        assert torch.equal(g, base[path]), path


def test_save_attn_keeps_attn_out_as_jax_does(model, capsys):
    """``offload_attn`` moves what ``save_attn`` keeps of the named stage
    outputs: ``attn_out`` of every layer.  The MoE output ``y`` is named
    too, but its only reader is the residual add, whose backward reads
    nothing, so nothing keeps it; JAX's save_attn residuals are the same
    whether its policy names ``mlp_out`` or not."""
    cfg, _, jp, tp = model
    batch = _batch(seed=5)
    B, T = batch["tokens"].shape[0], batch["tokens"].shape[1] - 1
    _, _, _, moved = _grads(tp, batch, "offload_attn")
    assert moved == (cfg.n_layers, cfg.n_layers * B * T * cfg.dim * 4)
    _, _, _, kept = _grads(tp, batch, "save_attn")
    assert kept == (0, 0)

    from deepspeed_tpu import remat as jremat
    from jax.ad_checkpoint import print_saved_residuals

    def residuals(names):
        orig = jremat.policy
        jremat.policy = lambda _: jax.checkpoint_policies \
            .save_only_these_names(*names)
        try:
            rcfg = dataclasses.replace(cfg, remat="save_attn")
            print_saved_residuals(
                lambda p: jm.loss_fn(rcfg)(
                    p, jax.tree.map(jnp.asarray, batch))[0],
                jax.tree.map(jnp.asarray, jp))
        finally:
            jremat.policy = orig
        return capsys.readouterr().out.count("\n")

    with contextlib.redirect_stderr(io.StringIO()):
        assert residuals(("attn_out", "mlp_out")) == residuals(("attn_out",))
        assert residuals(("attn_out",)) == residuals(()) + 1


def test_init_params_layout_std_and_seed():
    cfg = tm.MixtralConfig.tiny()
    p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                    dtype=torch.float32)
    ref = jm.init_params(jax.random.PRNGKey(0), jm.MixtralConfig.tiny())
    assert jax.tree.structure(jax.tree.map(lambda x: 0, ref)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, dict(p)))
    for path, leaf in tree_leaves_with_path(p):
        want = ref
        for key in path.split("/"):
            want = want[key]
        assert tuple(leaf.shape) == want.shape, path
    blocks = p["blocks"]
    for name, fan_in in (("w1", cfg.dim), ("w3", cfg.dim),
                         ("w2", cfg.ffn_dim), ("wq", cfg.dim)):
        std = blocks[name].std().item()
        assert abs(std - fan_in ** -0.5) < 0.1 * fan_in ** -0.5, name
    assert abs(blocks["gate"].std().item() - 0.02) < 0.004
    for name in ("attn_norm", "mlp_norm"):
        assert torch.equal(blocks[name], torch.ones_like(blocks[name]))
    again = init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                        dtype=torch.float32)
    other = init_params(cfg, torch.Generator().manual_seed(1), device="cpu",
                        dtype=torch.float32)
    assert torch.equal(again["blocks"]["w2"], blocks["w2"])
    assert not torch.equal(other["blocks"]["w2"], blocks["w2"])


@pytest.mark.parametrize("group_size", [128, 8])
def test_layerwise_int8_init_equals_quantize_params(group_size):
    """The layer-at-a-time int8 initialiser gives ``quantize_params`` of the
    same draws, code for code and scale for scale; the skipped leaves are
    the bf16 tree's."""
    cfg = tm.MixtralConfig.tiny()
    dense = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    want = tqz.quantize_params(dense, group_size=group_size,
                               skip_paths=MIXTRAL_INT8_SKIP)
    got = init_quantized_params(cfg, torch.Generator().manual_seed(3),
                                MIXTRAL_INT8_SKIP, device="cpu",
                                group_size=group_size)
    assert set(got) == set(want) and set(got["blocks"]) == set(
        want["blocks"])
    pairs = [(k, got[k], w) for k, w in want.items() if k != "blocks"] + [
        (f"blocks/{k}", got["blocks"][k], w)
        for k, w in want["blocks"].items()]
    for path, g, w in pairs:
        if isinstance(w, tqz.QuantizedTensor):
            assert isinstance(g, tqz.QuantizedTensor), path
            assert torch.equal(g.q, w.q) and torch.equal(g.scale, w.scale), \
                path
        else:
            assert torch.equal(g, w) and g.dtype == torch.bfloat16, path
    assert not isinstance(got["blocks"]["gate"], tqz.QuantizedTensor)
    assert isinstance(got["embed"], tqz.QuantizedTensor)


def test_sharding_and_streaming_raise(model):
    cfg, tcfg, _, tp = model
    # the sharding specs are ported: the JAX tree, P(...) as tuples
    want = jax.tree.map(tuple, jm.param_specs(cfg),
                        is_leaf=lambda x: isinstance(x, P))
    assert tm.param_specs(tcfg) == want
    # layer-streamed training is ported (tests/test_torch_param_stream.py
    # holds it to the JAX engine): the factoring carries the aux losses
    lm = tm.layered_model(tcfg, tp)
    assert lm.block_has_aux and lm.n_layers == tcfg.n_layers
    # weight-streamed serving is ported: the per-layer factoring serves
    # (tests/test_torch_zero_inference.py holds it to the resident engine)
    assert all(callable(f) for f in tm.paged_layered_fns(tcfg))
