"""GPT-2 of the port against the JAX model on ``GPT2Config.tiny()`` with the
same weights through ``from_jax_params``.

Tolerances: f32 logits at 1e-4 (test_torch_llama.py's: the same
operations summed in another order over two layers); f32 gradients at
1e-4 relative / 1e-6 absolute (test_torch_remat.py's); the int8 forward
runs f32 activations against bf16-valued weights on both sides (jnp
promotes, the port casts to the promoted dtype), so it is held at 1e-4
too; bf16 logits at 0.06 (test_torch_llama.py's bf16 bound) and the bf16
``wte`` gradient, which sums the gather's and the tied head's
contributions, at four bf16 ulps of its largest element: the head's
contribution is one f32 product rounded once, but the gather's is the
embedding's cotangent after the whole bf16 backward through both layers,
rounded at other places in the two frameworks (seeds 0-5 read 1.4-2.6
ulps).  Every
remat policy gives the gradients of ``remat="none"`` exactly: the
recompute runs the same operations on the same inputs, and the offload
policies keep the same tensors (the identity on the CPU).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import quantized as jqz
from deepspeed_tpu.inference.generation import KVCache as JDense
from deepspeed_tpu.inference.kernels import PagedKVCache as JCache
from deepspeed_tpu.models import gpt2 as jg
from deepspeed_tpu_torch import remat as tremat
from deepspeed_tpu_torch._tree import tree_leaves_with_path
from deepspeed_tpu_torch.inference.generation import KVCache as TDense
from deepspeed_tpu_torch.inference.kernels import PagedKVCache as TCache
from deepspeed_tpu_torch.inference.serving import (GPT2_INT8_SKIP,
                                                   gpt2_serving_engine)
from deepspeed_tpu_torch.models import gpt2 as tg
from deepspeed_tpu_torch.weights import from_jax_params, init_params

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
ALL_POLICIES = tremat.POLICIES + tuple(tremat.OFFLOAD)


@pytest.fixture(scope="module")
def model():
    cfg = jg.GPT2Config.tiny()
    jp = jax.device_get(jg.init_params(jax.random.PRNGKey(0), cfg))
    # non-zero biases and LayerNorm affines, so every leaf carries signal
    rng = np.random.default_rng(9)
    for name, leaf in jp["blocks"].items():
        if name.endswith("_b") or name.startswith("ln"):
            jp["blocks"][name] = (leaf + rng.normal(0, 0.05, leaf.shape)
                                  ).astype(np.float32)
    tp = from_jax_params(jp, device="cpu")
    return cfg, tg.GPT2Config.tiny(), jp, tp


def _tokens(B, T, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, T)).astype(
        np.int32)


def test_bridge_is_a_plain_copy(model):
    _, _, jp, tp = model
    assert set(tp) == set(jp) and set(tp["blocks"]) == set(jp["blocks"])
    for path, leaf in tree_leaves_with_path(tp):
        want = jp
        for key in path.split("/"):
            want = want[key]
        assert leaf.dtype == torch.float32
        np.testing.assert_array_equal(leaf.numpy(), want)


def test_config_presets_and_param_count():
    for preset in ("tiny", "gpt2_1_3b"):
        a = dataclasses.asdict(getattr(jg.GPT2Config, preset)())
        b = dataclasses.asdict(getattr(tg.GPT2Config, preset)())
        assert b == a
    for cfg in (tg.GPT2Config(), tg.GPT2Config.gpt2_1_3b(),
                tg.GPT2Config.tiny()):
        jcfg = jg.GPT2Config(**dataclasses.asdict(cfg))
        assert tg.param_count(cfg) == jg.param_count(jcfg)
        assert cfg.n_kv_heads == cfg.n_heads
    big = tg.GPT2Config.gpt2_1_3b()
    assert tg.param_count(big) == 1_313_626_112 and big.head_dim == 128
    assert tg.GPT2Config().head_dim == 64
    with pytest.raises(ValueError, match="remat"):
        tg.GPT2Config.tiny(remat="bogus")


def test_forward_logits(model):
    cfg, tcfg, jp, tp = model
    toks = _tokens(2, 13)
    want = np.asarray(jg.forward(jp, jnp.asarray(toks), cfg))
    got = tg.forward(tp, torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 13, 256)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def _grads(tp, toks, remat="none"):
    tp = {k: ({n: w.detach().clone().requires_grad_(True)
               for n, w in v.items()} if isinstance(v, dict)
              else v.detach().clone().requires_grad_(True))
          for k, v in tp.items()}
    loss = tg.loss_fn(tg.GPT2Config.tiny(remat=remat))(
        tp, {"tokens": torch.from_numpy(toks)})
    loss.backward()
    return loss.item(), {p: t.grad for p, t in tree_leaves_with_path(tp)}


def test_loss_and_gradients_of_every_leaf(model):
    cfg, _, jp, tp = model
    toks = _tokens(2, 17, seed=4)
    jloss, jgrads = jax.value_and_grad(jg.loss_fn(cfg))(
        jax.tree.map(jnp.asarray, jp), {"tokens": jnp.asarray(toks)})
    loss, got = _grads(tp, toks)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    want = {"/".join(str(k.key) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert got.keys() == want.keys() and len(got) == 16
    for path, g in got.items():
        assert np.abs(g.numpy()).max() > 0, path
        np.testing.assert_allclose(g.numpy(), want[path], rtol=1e-4,
                                   atol=1e-6, err_msg=path)


@pytest.mark.parametrize("remat", [p for p in ALL_POLICIES if p != "none"])
def test_every_remat_policy_gives_the_gradients_of_none(model, remat):
    _, _, _, tp = model
    toks = _tokens(2, 17, seed=4)
    base_loss, base = _grads(tp, toks)
    loss, got = _grads(tp, toks, remat)
    assert loss == base_loss
    for path, g in got.items():
        assert torch.equal(g, base[path]), path


def test_tied_head_gradient_in_bf16(model):
    """The bf16 ``wte`` gradient (gather + tied head) against JAX's bf16."""
    cfg, _, jp, _ = model
    jp16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jp)
    tp16 = from_jax_params(jax.device_get(jp16), device="cpu")
    toks = _tokens(2, 17, seed=5)
    jgrad = jax.grad(jg.loss_fn(cfg))(jp16, {"tokens": jnp.asarray(toks)})
    tp16["wte"].requires_grad_(True)
    tg.loss_fn(tg.GPT2Config.tiny())(tp16, {"tokens": torch.from_numpy(
        toks)}).backward()
    got = tp16["wte"].grad.float().numpy()
    want = np.asarray(jgrad["wte"], np.float32)
    ulp = np.abs(want).max() * 2.0 ** -8
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * ulp)


def test_bf16_logits_close_to_jax_bf16(model):
    cfg, tcfg, jp, _ = model
    jp16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jp)
    tp16 = from_jax_params(jax.device_get(jp16), device="cpu")
    toks = _tokens(2, 10, seed=3)
    want = np.asarray(jg.forward(jp16, jnp.asarray(toks), cfg))
    got = tg.forward(tp16, torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0.06)


def test_forward_with_cache_prefill_then_decode(model):
    cfg, tcfg, jp, tp = model
    jc = JDense.alloc(cfg.n_layers, 2, 24, cfg.n_kv_heads, cfg.head_dim,
                      dtype=jnp.float32)
    tc = TDense.alloc(cfg.n_layers, 2, 24, cfg.n_kv_heads, cfg.head_dim,
                      dtype=torch.float32, device="cpu")
    for i, T in enumerate((9, 1, 1, 3)):
        toks = _tokens(2, T, seed=30 + i)
        want, jc = jg.forward_with_cache(jp, jnp.asarray(toks), cfg, jc)
        got, tc = tg.forward_with_cache(tp, torch.from_numpy(toks), tcfg, tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert tc.length == int(jc.length)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **TOL)


def _caches(cfg, B, ps=4, max_seq=64, dtype=jnp.float32):
    mp = -(-max_seq // ps)
    j = JCache.alloc(cfg.n_layers, cfg.n_kv_heads, B * mp + 1, ps,
                     cfg.head_dim, B, max_seq, dtype=dtype)
    t = TCache.alloc(cfg.n_layers, cfg.n_kv_heads, B * mp + 1, ps,
                     cfg.head_dim, B, max_seq, dtype=torch.float32,
                     device="cpu")
    np.testing.assert_array_equal(t.table.numpy(), np.asarray(j.table))
    return j, t


def test_forward_paged_whole_chunked_and_decode(model):
    """Whole-prompt prefill, decode steps and a split-fuse chunk against
    JAX's ``paged_kernel="xla"`` arm; the cache and frontiers too."""
    cfg, tcfg, jp, tp = model
    jc, tc = _caches(cfg, B=2)

    def both(toks, cont=False):
        nonlocal jc, tc
        want, jc = jg.forward_paged(jp, jnp.asarray(toks), cfg, jc,
                                    continuation=cont, tp=False,
                                    paged_kernel="xla")
        got, tc = tg.forward_paged(tp, torch.from_numpy(toks), tcfg, tc,
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


def test_forward_paged_chunked_prefill_equals_dense_forward(model):
    _, tcfg, _, tp = model
    toks = _tokens(1, 20, seed=2)
    _, tc = _caches(tcfg, B=1)
    out = []
    for lo in range(0, 20, 8):
        logits, tc = tg.forward_paged(tp, torch.from_numpy(toks[:, lo:lo + 8]),
                                      tcfg, tc, continuation=True)
        out.append(logits)
    dense = tg.forward(tp, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(torch.cat(out, 1).numpy(), dense.numpy(),
                               **TOL)


def test_positions_past_the_table_clamp_as_jax(model):
    """A continuation chunk that runs past ``max_seq_len``: both clamp the
    position gather into the table's last row (no device-side index
    error), and score the same logits."""
    cfg, _, jp, tp = model
    small = dataclasses.replace(cfg, max_seq_len=12)
    tsmall = tg.GPT2Config.tiny(max_seq_len=12)
    jps = jax.tree.map(jnp.asarray, dict(jp, wpe=jp["wpe"][:12]))
    tps = dict(tp, wpe=tp["wpe"][:12])
    jc, tc = _caches(small, B=2, max_seq=24)
    for toks, cont in ((_tokens(2, 10, seed=5), False),
                       (_tokens(2, 6, seed=6), True)):
        want, jc = jg.forward_paged(jps, jnp.asarray(toks), small, jc,
                                    continuation=cont, tp=False,
                                    paged_kernel="xla")
        got, tc = tg.forward_paged(tps, torch.from_numpy(toks), tsmall, tc,
                                   continuation=cont)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_int8_forward_paged_close_to_jax_quantized(model):
    cfg, tcfg, jp, _ = model
    jqp = jqz.quantize_params(jax.tree.map(jnp.asarray, jp),
                              skip_paths=GPT2_INT8_SKIP)
    tqp = from_jax_params(jax.device_get(jqp), device="cpu")
    assert isinstance(tqp["blocks"]["qkv_w"], tuple)
    assert torch.is_tensor(tqp["wpe"]) and torch.is_tensor(
        tqp["blocks"]["qkv_b"])
    jstep = jqz.quantized_apply(
        lambda p, t, c, cont: jg.forward_paged(p, t, cfg, c, tp=False,
                                               paged_kernel="xla",
                                               continuation=cont))
    jc, tc = _caches(cfg, B=2)

    def both(toks, cont=False):
        nonlocal jc, tc
        want, jc = jstep(jqp, jnp.asarray(toks), jc, cont)
        got, tc = tg.forward_paged(tqp, torch.from_numpy(toks), tcfg, tc,
                                   continuation=cont)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    both(_tokens(2, 9, seed=1))
    for i in range(3):
        both(_tokens(2, 1, seed=10 + i))
    both(_tokens(2, 6, seed=20), cont=True)


def test_segment_ids_and_max_seq_raise(model):
    _, tcfg, _, tp = model
    toks = torch.from_numpy(_tokens(1, 9))
    with pytest.raises(NotImplementedError, match="segment_ids"):
        tg.loss_fn(tcfg)(tp, {"tokens": toks,
                              "segment_ids": torch.ones_like(toks)})
    with pytest.raises(ValueError, match="position table"):
        gpt2_serving_engine(tp, tcfg, device="cpu", max_seq=129,
                            num_pages=40)


def test_init_params_layout_and_scale():
    cfg = tg.GPT2Config.tiny(dim=128, vocab_size=512)
    p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                    dtype=torch.float32)
    j = jax.device_get(jg.init_params(jax.random.PRNGKey(0), jg.GPT2Config(
        **dataclasses.asdict(cfg))))
    for path, leaf in tree_leaves_with_path(p):
        want = j
        for key in path.split("/"):
            want = want[key]
        assert tuple(leaf.shape) == want.shape, path
    for name in ("wte", "wpe"):
        assert abs(float(p[name].std()) - 0.02) < 0.002
    for name in ("qkv_w", "proj_w", "fc_w", "out_w"):
        assert abs(float(p["blocks"][name].std()) - 0.02) < 0.002
    for name in ("ln1_w", "ln2_w"):
        assert torch.equal(p["blocks"][name], torch.ones_like(
            p["blocks"][name]))
    for name in ("ln1_b", "qkv_b", "proj_b", "ln2_b", "fc_b", "out_b"):
        assert not p["blocks"][name].any()
    assert torch.equal(p["lnf_w"], torch.ones(128)) and not p["lnf_b"].any()
    # seeded: the same generator seed gives the same weights
    again = init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                        dtype=torch.float32)
    assert torch.equal(again["blocks"]["fc_w"], p["blocks"]["fc_w"])
