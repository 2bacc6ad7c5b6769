"""Block-sparse attention of the port (``ops/sparse_attention.py``,
``LlamaConfig(attn_impl="sparse")``) against the JAX package's.

- every layout's ``make_layout`` is JAX's, bit for bit, at several sequence
  lengths and seeds (the same numpy code and ``RandomState`` draws);
- ``sparsity_config_from_dict`` builds the same configs and raises the
  same errors;
- ``sparse_attention`` outputs and gradients in f32 against ``jax.vjp`` of
  the JAX function, causal or not, with ``attn_mask`` and ``segment_ids``:
  2e-5 (both compute the same f32 sums in another order), and against an
  oracle independent of the gather (dense f32 attention under the layout
  expanded to a token mask);
- Llama's ``forward`` / ``loss_fn`` with ``attn_impl="sparse"`` (GQA) on
  bridged weights against JAX: logits 1e-4, loss 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-5)

LAYOUTS = {
    "dense": dict(),
    "fixed": dict(num_local_blocks=2, num_global_blocks=1),
    "fixed_causal_horizontal": dict(num_local_blocks=3, num_global_blocks=1,
                                    attention="unidirectional",
                                    horizontal_global_attention=True),
    "fixed_horizontal": dict(num_local_blocks=2, num_global_blocks=1,
                             horizontal_global_attention=True),
    "variable": dict(num_random_blocks=2, local_window_blocks=(2, 3),
                     global_block_indices=(0, 3),
                     horizontal_global_attention=True),
    "variable_causal": dict(num_random_blocks=1, local_window_blocks=(2,),
                            attention="unidirectional"),
    "bigbird": dict(num_random_blocks=2, num_sliding_window_blocks=3,
                    num_global_blocks=1),
    "bigbird_per_head": dict(num_random_blocks=1, different_layout_per_head=True,
                             attention="unidirectional"),
    "bslongformer": dict(num_sliding_window_blocks=3,
                         global_block_indices=(0, 2),
                         global_block_end_indices=(1, 4)),
    "local_sliding_window": dict(num_sliding_window_blocks=3),
    "local_sliding_window_bidir": dict(num_sliding_window_blocks=3,
                                       attention="bidirectional"),
}
_CLASSES = {"dense": "DenseSparsityConfig", "fixed": "FixedSparsityConfig",
            "variable": "VariableSparsityConfig",
            "bigbird": "BigBirdSparsityConfig",
            "bslongformer": "BSLongformerSparsityConfig",
            "local": "LocalSlidingWindowSparsityConfig"}


def _cls(mod, name):
    key = next(k for k in _CLASSES if name.startswith(k))
    return getattr(mod, _CLASSES[key])


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layouts_equal_jax(name):
    kw = LAYOUTS[name]
    for seed in (0, 3):
        extra = dict(seed=seed) if "seed" in {
            f.name for f in dataclasses.fields(_cls(jsa, name))} else {}
        for seq in (64, 96, 160):
            want = _cls(jsa, name)(num_heads=3, block=16, **kw,
                                   **extra).make_layout(seq)
            got = _cls(tsa, name)(num_heads=3, block=16, **kw,
                                  **extra).make_layout(seq)
            assert got.dtype == want.dtype == bool
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(tsa._gather_plan(got)[0],
                                          jsa._gather_plan(want)[0])


@pytest.mark.parametrize("d", [
    {"mode": "fixed", "block": 32, "num_local_blocks": 2},
    {"mode": "BigBird", "block": 16, "num_random_blocks": 2,
     "num_heads": 99},
    {"mode": "variable", "local_window_blocks": [1, 2],
     "global_block_indices": [0]},
    {"mode": "dense"},
    {},
    {"mode": "nope"},
    {"mode": "dense", "num_local_blocks": 2},
])
def test_sparsity_config_from_dict_matches_jax(d):
    def build(mod):
        try:
            c = mod.sparsity_config_from_dict(d, 4,
                                              attention="unidirectional")
        except Exception as e:
            return type(e).__name__, str(e)
        return type(c).__name__, dataclasses.asdict(c)

    assert build(tsa) == build(jsa)


def _qkv(seed, B=2, H=2, S=64, D=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, S, D)).astype(np.float32)
            for _ in range(3)] + [rng.standard_normal((B, H, S, D)).astype(
                np.float32)]


def _masks(B=2, S=64):
    mask = np.ones((B, S), np.int32)
    mask[1, 40:] = 0
    seg = np.zeros((B, S), np.int32)
    seg[:, 24:] = 1
    seg[1, 50:] = 2
    return mask, seg


def _dense_oracle(q, k, v, lay, block, causal, mask=None, seg=None):
    """Dense f32 attention under the layout expanded to a token mask."""
    tok = np.repeat(np.repeat(lay, block, 1), block, 2)      # [H, S, S]
    allow = np.broadcast_to(tok[None], (q.shape[0],) + tok.shape).copy()
    S = q.shape[2]
    if causal:
        allow &= np.tril(np.ones((S, S), bool))[None, None]
    if mask is not None:
        allow &= mask.astype(bool)[:, None, None, :]
    if seg is not None:
        allow &= (seg[:, None, :, None] == seg[:, None, None, :])
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    s = np.where(allow, s, -np.inf)
    m = s.max(-1, keepdims=True)
    p = np.exp(s - np.where(np.isfinite(m), m, 0))
    den = p.sum(-1, keepdims=True)
    out = np.einsum("bhqk,bhkd->bhqd", p / np.where(den > 0, den, 1), v)
    return np.where(allow.any(-1, keepdims=True), out, 0.0)


@pytest.mark.parametrize("name", ["fixed", "bigbird", "local_sliding_window",
                                  "dense"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masks", ["none", "attn_mask", "segments"])
def test_sparse_attention_outputs_and_grads_match_jax(name, causal, masks):
    q, k, v, g = _qkv(1)
    cfg = _cls(jsa, name)(num_heads=2, block=16, **LAYOUTS[name])
    lay = cfg.make_layout(64)
    mask, seg = _masks()
    am = mask if masks == "attn_mask" else None
    sg = seg if masks == "segments" else None

    def jf(q, k, v):
        return jsa.sparse_attention(
            q, k, v, lay, 16, causal=causal,
            attn_mask=None if am is None else jnp.asarray(am),
            segment_ids=None if sg is None else jnp.asarray(sg))

    want, vjp = jax.vjp(jf, *(jnp.asarray(x) for x in (q, k, v)))
    wgrads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    got = tsa.sparse_attention(
        tq, tk, tv, lay, 16, causal=causal,
        attn_mask=None if am is None else torch.from_numpy(am),
        segment_ids=None if sg is None else torch.from_numpy(sg))
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for t, w in zip((tq, tk, tv), wgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(
        got.detach().numpy(), _dense_oracle(q, k, v, lay, 16, causal, am, sg),
        rtol=1e-5, atol=1e-5)


def test_sparse_self_attention_module_and_density():
    cfg = tsa.FixedSparsityConfig(num_heads=2, block=16, num_local_blocks=2,
                                  attention="unidirectional")
    sa, jsa_ = tsa.SparseSelfAttention(cfg), jsa.SparseSelfAttention(
        jsa.FixedSparsityConfig(num_heads=2, block=16, num_local_blocks=2,
                                attention="unidirectional"))
    assert sa.causal and sa.density(64) == jsa_.density(64)
    q, k, v, _ = _qkv(2)
    got = sa(*(torch.from_numpy(x) for x in (q, k, v)))
    want = jsa_(*(jnp.asarray(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # one head's rows of the layout (a tensor-parallel rank's)
    one = sa(*(torch.from_numpy(x[:, 1:]) for x in (q, k, v)),
             heads=slice(1, 2))
    np.testing.assert_allclose(one.numpy(), got.numpy()[:, 1:], **TOL)
    with pytest.raises(ValueError, match="layout shape"):
        tsa.sparse_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             cfg.make_layout(32), 16)


SPARSE = {"mode": "fixed", "block": 16, "num_local_blocks": 2,
          "num_global_blocks": 1}


@pytest.mark.parametrize("sparse", [SPARSE, {"mode": "bigbird", "block": 16,
                                             "num_random_blocks": 1}])
def test_llama_sparse_forward_and_loss_match_jax(sparse):
    kw = dict(dim=64, n_heads=4, n_kv_heads=2, attn_impl="sparse",
              sparse_config=sparse)
    jcfg, tcfg = jl.LlamaConfig.tiny(**kw), tl.LlamaConfig.tiny(**kw)
    jp = jax.device_get(jl.init_params(jax.random.PRNGKey(0), jcfg))
    tp = from_jax_params(jp, device="cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 256, (2, 65)).astype(np.int32)
    want = np.asarray(jl.forward(jp, jnp.asarray(toks[:, :-1]), jcfg))
    got = tl.forward(tp, torch.from_numpy(toks[:, :-1]), tcfg)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4)
    seg = np.zeros((2, 65), np.int32)
    seg[:, 30:] = 1
    batch = {"tokens": toks, "segment_ids": seg}
    jloss = float(jl.loss_fn(jcfg)(jp, {k: jnp.asarray(v)
                                        for k, v in batch.items()}))
    tloss = tl.loss_fn(tcfg)(tp, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), jloss, rtol=1e-5)
    # the dense layout is plain causal attention
    dcfg = tl.LlamaConfig.tiny(dim=64, n_heads=4, n_kv_heads=2,
                               attn_impl="sparse",
                               sparse_config={"mode": "dense", "block": 16})
    ref = tl.LlamaConfig.tiny(dim=64, n_heads=4, n_kv_heads=2,
                              attn_impl="reference")
    np.testing.assert_allclose(
        tl.forward(tp, torch.from_numpy(toks[:, :-1]), dcfg).detach().numpy(),
        tl.forward(tp, torch.from_numpy(toks[:, :-1]), ref).detach().numpy(),
        rtol=1e-4, atol=1e-4)
