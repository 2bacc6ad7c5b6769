"""Weight-only int8 inference of the port against the JAX package
(``deepspeed_tpu/inference/quantized.py``, ``init_inference(dtype="int8")``,
the int8 ``llama_serving_engine``) on llama-tiny, the same weights through
``from_jax_params``.

- ``quantize_params`` codes and scales are held EXACTLY equal to JAX's, on
  f32 and bf16 weights; ``_pick_groups`` and ``quantization_error`` too.
- The int8 forward runs in bf16 on both sides (the dequantized weights are
  bf16), and the two frameworks round bf16 at different places, so logits
  are held at a bf16 tolerance (see ``BF16_ATOL``), not bit for bit.
- Inside the port, the int8 engine is held to token identity: against its
  own offline int8 greedy loop, and against a bf16 engine over the
  dequantized weights (the same values through the same operations).
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
from deepspeed_tpu.inference import quantized as jqz
from deepspeed_tpu.inference.kernels import PagedKVCache as JCache
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.inference import init_serving
from deepspeed_tpu_torch.inference import quantized as tqz
from deepspeed_tpu_torch.inference.kernels import PagedKVCache as TCache
from deepspeed_tpu_torch.inference.serving import llama_serving_engine
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

# bf16 logits of the two frameworks: 8 mantissa bits per rounding (a bf16
# ulp at |4| is 0.0156), logits up to |4.3| here, two layers; the
# init_inference case read 0.047 (three ulps), the bound is
# test_torch_llama.py's bf16 one
BF16_ATOL = 0.06
SERVE = dict(max_batch=2, page_size=8, num_pages=48, max_seq=64,
             prefill_bucket=8)


@pytest.fixture(scope="module")
def model():
    cfg = jl.LlamaConfig.tiny()
    jp = jl.init_params(jax.random.PRNGKey(0), cfg)
    tp = from_jax_params(jax.device_get(jp), device="cpu")
    return cfg, tl.LlamaConfig.tiny(), jp, tp


def _tokens(B, T, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, T)).astype(
        np.int32)


def _assert_trees_equal(tq, jq_):
    assert set(tq) == set(jq_)
    for k, t in tq.items():
        j = jq_[k]
        if isinstance(t, dict):
            _assert_trees_equal(t, j)
        elif isinstance(t, tqz.QuantizedTensor):
            assert isinstance(j, jqz.QuantizedTensor), k
            assert t.q.dtype == torch.int8 and tuple(t.scale.shape) == \
                j.scale.shape, k
            np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
            np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
        else:
            assert not isinstance(j, jqz.QuantizedTensor), k
            np.testing.assert_array_equal(t.float().numpy(),
                                          np.asarray(j, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group_size,skip", [
    (128, ()), (64, ()), (16, ("attn_norm", "mlp_norm", "final_norm"))])
def test_quantize_params_bit_equal_to_jax(model, dtype, group_size, skip):
    _, _, jp, _ = model
    jw = jax.tree.map(lambda a: a.astype(dtype), jp)
    tw = from_jax_params(jax.device_get(jw), device="cpu")
    tqp = tqz.quantize_params(tw, group_size=group_size, skip_paths=skip)
    jqp = jqz.quantize_params(jw, group_size=group_size, skip_paths=skip)
    _assert_trees_equal(tqp, jqp)
    # the stacked norm gains quantize unless skipped; final_norm is 1-D
    assert isinstance(tqp["blocks"]["attn_norm"], tqz.QuantizedTensor) == \
        (not skip)
    assert not isinstance(tqp["final_norm"], tqz.QuantizedTensor)
    # a quantized tree passes through unchanged
    again = tqz.quantize_params(tqp, group_size=group_size)
    assert again["blocks"]["wq"] is tqp["blocks"]["wq"]
    # dequantized values equal JAX's (bf16, as quantized_apply computes)
    td = tqz.dequantize_params(tqp)
    jd = jqz.dequantize_params(jqp)
    np.testing.assert_array_equal(
        td["blocks"]["w1"].float().numpy(),
        np.asarray(jd["blocks"]["w1"].astype(jnp.float32)))
    # the JAX tree carried across by from_jax_params is the same tree
    _assert_trees_equal(from_jax_params(jax.device_get(jqp), device="cpu"),
                        jqp)


@pytest.mark.parametrize("shape,group_size", [
    ((50257, 768), 128), ((97, 13), 128), ((4, 96), 128), ((8, 1000), 64),
    ((3, 5, 7), 4), ((2, 6), 128)])
def test_pick_groups_equal_to_jax(shape, group_size):
    meta = torch.empty(shape, device="meta")
    fake = types.SimpleNamespace(size=int(np.prod(shape)), ndim=len(shape),
                                 shape=shape)
    g = tqz._pick_groups(meta, group_size)
    assert g == jqz._pick_groups(fake, group_size)
    assert meta.numel() % g == 0


def test_pick_groups_prime_rows_warn(caplog):
    leaf = torch.empty((50257, 768), device="meta")
    assert leaf.numel() // tqz._pick_groups(leaf, 128) <= 8 * 128
    with caplog.at_level("WARNING"):
        g = tqz._pick_groups(torch.empty((3, 1031), device="meta"), 16)
    assert g == 3 and "expect elevated quantization error" in caplog.text


def test_quantization_error_equal_to_jax(model):
    _, _, jp, tp = model
    tqp = tqz.quantize_params(tp, group_size=64)
    jqp = jqz.quantize_params(jp, group_size=64)
    got = tqz.quantization_error(tp, tqp)
    want = jqz.quantization_error(jp, jqp)
    assert 0 < got < 0.02
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_memory_about_halves_vs_bf16(model):
    _, _, jp, _ = model
    tw = from_jax_params(jax.device_get(jp), device="cpu",
                         dtype=torch.bfloat16)
    ratio = tqz.param_bytes(tqz.quantize_params(tw)) / tqz.param_bytes(tw)
    # int8 codes are half the bf16 bytes; f32 scales per 128 elements add
    # ~3 %: past 0.56 the grouping regressed
    assert ratio < 0.56, ratio


def test_init_inference_int8_logits_close_to_jax(model, devices):
    cfg, tcfg, jp, tp = model
    toks = _tokens(2, 12)
    jfwd = lambda p, t: jl.forward(p, t, cfg)  # noqa: E731
    want = np.asarray(dstpu.init_inference(apply_fn=jfwd, params=jp,
                                           dtype="int8")(jnp.asarray(toks)))
    want32 = np.asarray(dstpu.init_inference(apply_fn=jfwd,
                                             params=jp)(jnp.asarray(toks)))
    eng = init_inference(apply_fn=lambda p, t: tl.forward(p, t, tcfg),
                         params=tp, dtype="int8", device="cpu")
    # every ndim >= 2 leaf quantizes, the stacked norm gains too
    assert isinstance(eng.params["blocks"]["mlp_norm"], tqz.QuantizedTensor)
    got = eng(torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BF16_ATOL)
    agree = float(np.mean(got.numpy().argmax(-1) == want32.argmax(-1)))
    assert agree >= 0.9, agree
    # the lazy per-layer dequantization of forward gives what the
    # whole-tree dequantization of quantized_apply gives, bit for bit
    direct = tl.forward(eng.params, torch.from_numpy(toks), tcfg)
    assert torch.equal(direct, got)


def test_init_inference_hands_int8_tree_to_llama_forward(model,
                                                         monkeypatch):
    """A forward marked ``takes_quantized`` (a ``functools.partial`` of
    llama's) gets the int8 tree as it is, with no whole-tree
    dequantization per call, and gives the wrapped forward's logits bit
    for bit."""
    _, tcfg, _, tp = model
    toks = torch.from_numpy(_tokens(2, 12))
    want = init_inference(apply_fn=lambda p, t: tl.forward(p, t, tcfg),
                          params=tp, dtype="int8", device="cpu")(toks)
    eng = init_inference(apply_fn=functools.partial(tl.forward, cfg=tcfg),
                         params=tp, dtype="int8", device="cpu")

    def whole_tree(*_a, **_k):
        raise AssertionError("the int8 tree was dequantized whole")

    monkeypatch.setattr(tqz, "dequantize_params", whole_tree)
    assert torch.equal(eng(toks), want)


def test_init_inference_other_dtypes_and_errors(model):
    _, tcfg, _, tp = model
    eng = init_inference(apply_fn=lambda p, t: tl.forward(p, t, tcfg),
                         params=tp, dtype="float32", device="cpu",
                         config={"train_batch_size": 1})
    out = eng.forward(torch.from_numpy(_tokens(1, 5)))
    assert out.shape == (1, 5, 256) and not out.requires_grad
    with pytest.raises(ValueError, match="params"):
        init_inference(apply_fn=lambda p, t: t, device="cpu")
    with pytest.raises(ValueError, match="apply_fn"):
        init_inference(params=tp, device="cpu")
    # a mesh is ported (tests/test_torch_serving_tp.py): one that is no
    # MeshSpec raises, and so do specs without a mesh
    for tp_kw, err, match in (({"mesh": object()}, TypeError, "MeshSpec"),
                              ({"param_specs": {}}, ValueError, "mesh")):
        with pytest.raises(err, match=match):
            init_inference(apply_fn=lambda p, t: t, params=tp, device="cpu",
                           **tp_kw)


def _caches(cfg, B, ps=4, max_seq=32):
    P = B * -(-max_seq // ps) + 1
    j = JCache.alloc(cfg.n_layers, cfg.n_kv_heads, P, ps, cfg.head_dim, B,
                     max_seq, dtype=jnp.float32)
    t = TCache(k=torch.zeros(j.k.shape), v=torch.zeros(j.v.shape),
               table=torch.from_numpy(np.array(j.table)),
               seq_lens=torch.zeros((B,), dtype=torch.int32), page_size=ps)
    return j, t


def test_int8_forward_paged_close_to_jax_quantized_apply(model):
    cfg, tcfg, jp, _ = model
    jqp = jqz.quantize_params(
        jp, skip_paths=("attn_norm", "mlp_norm", "final_norm"))
    tqp = from_jax_params(jax.device_get(jqp), device="cpu")
    jstep = jqz.quantized_apply(
        lambda p, t, c, cont: jl.forward_paged(p, t, cfg, c, tp=False,
                                               paged_kernel="xla",
                                               continuation=cont))
    jc, tc = _caches(cfg, B=2)

    def both(toks, cont=False):
        nonlocal jc, tc
        want, jc = jstep(jqp, jnp.asarray(toks), jc, cont)
        got, tc = tl.forward_paged(tqp, torch.from_numpy(toks), tcfg, tc,
                                   continuation=cont)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=BF16_ATOL)

    both(_tokens(2, 9, seed=1))                       # prefill
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=0,
                               atol=BF16_ATOL)
    for i in range(3):                                # decode
        both(_tokens(2, 1, seed=10 + i))
    both(_tokens(2, 6, seed=20), cont=True)           # continuation chunk
    np.testing.assert_array_equal(tc.seq_lens.numpy(),
                                  np.asarray(jc.seq_lens))


def _offline_greedy(qp, tcfg, prompt, new_tokens, ps=8, max_seq=64):
    """The port's own int8 greedy loop over one paged cache (B=1)."""
    mp = -(-max_seq // ps)
    shape = (tcfg.n_layers, tcfg.n_kv_heads, mp + 1, ps, tcfg.head_dim)
    cache = TCache(k=torch.zeros(shape, dtype=torch.bfloat16),
                   v=torch.zeros(shape, dtype=torch.bfloat16),
                   table=torch.arange(mp, dtype=torch.int32)[None],
                   seq_lens=torch.zeros((1,), dtype=torch.int32),
                   page_size=ps)
    out = list(prompt)
    toks = torch.tensor([prompt], dtype=torch.int32)
    for _ in range(new_tokens):
        logits, cache = tl.forward_paged(qp, toks, tcfg, cache)
        nxt = int(logits[0, -1].argmax())
        out.append(nxt)
        toks = torch.tensor([[nxt]], dtype=torch.int32)
    return out


def test_int8_serving_matches_offline_int8_forward(model):
    _, tcfg, _, tp = model
    prompts = {"a": list(range(5, 21)), "b": [7, 3, 9, 200, 11, 4, 8, 1]}
    eng = llama_serving_engine(tp, tcfg, weight_dtype="int8", device="cpu",
                               **dict(SERVE, max_batch=1))
    assert isinstance(eng.params["blocks"]["wq"], tqz.QuantizedTensor)
    assert not isinstance(eng.params["blocks"]["attn_norm"],
                          tqz.QuantizedTensor)
    for rid, p in prompts.items():
        eng.submit(rid, p, max_new_tokens=6)
    out = eng.run()
    assert eng.check_leaks() == []
    qp = tqz.quantize_params(
        tp, skip_paths=("attn_norm", "mlp_norm", "final_norm"))
    for rid, p in prompts.items():
        assert out[rid] == _offline_greedy(qp, tcfg, p, 6), rid


@pytest.mark.parametrize("kw", [
    {}, {"prefill_chunk": 8}, {"decode_chunk": 3}])
def test_int8_engine_equals_bf16_engine_on_dequantized_weights(model, kw):
    _, tcfg, _, tp = model
    rng = np.random.default_rng(4)
    prompts = {f"r{i}": rng.integers(1, 256, rng.integers(3, 30)).tolist()
               for i in range(4)}
    qp = tqz.quantize_params(
        tp, skip_paths=("attn_norm", "mlp_norm", "final_norm"))
    outs = []
    for params, wd in ((tp, "int8"), (tqz.dequantize_params(qp), "bfloat16")):
        eng = llama_serving_engine(params, tcfg, weight_dtype=wd,
                                   device="cpu", **SERVE, **kw)
        for rid, p in prompts.items():
            eng.submit(rid, p, max_new_tokens=8)
        outs.append(eng.run())
        assert eng.check_leaks() == []
    assert outs[0] == outs[1]
    assert all(len(v) == len(prompts[r]) + 8 for r, v in outs[0].items())


def _waves(seed=3, prefix=40, suffix=9, n=3):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 256, prefix).tolist()
    return [{f"{w}{i}": shared + rng.integers(1, 256, suffix).tolist()
             for i in range(n)} for w in "AB"]


def test_int8_weights_with_prefix_cache_and_int8_resident_tier(model):
    _, tcfg, _, tp = model
    kv = {"quantize_cold": True, "quantized_resident": True,
          "demote_watermark": 0.0}
    qp = tqz.quantize_params(
        tp, skip_paths=("attn_norm", "mlp_norm", "final_norm"))
    outs, engines = [], []
    for params, wd in ((tp, "int8"), (tqz.dequantize_params(qp), "bfloat16")):
        eng = llama_serving_engine(params, tcfg, weight_dtype=wd,
                                   device="cpu", prefix_cache={}, kv_tier=kv,
                                   prefill_chunk=8,
                                   **dict(SERVE, num_pages=64, max_seq=96))
        out = {}
        for wave in _waves():
            for rid, p in wave.items():
                eng.submit(rid, p, max_new_tokens=6)
            out.update(eng.run())
        assert eng.check_leaks() == []
        assert eng.cache.k.dtype == torch.int8
        assert eng.allocator.demoted > 0 and eng.allocator.promoted > 0
        assert eng.kv_tier_quant_resident_promotes > 0
        assert eng.prefix_cache_hits > 0
        outs.append(out)
        engines.append(eng)
    assert outs[0] == outs[1]


def test_unknown_weight_dtype_raises(model):
    _, tcfg, _, tp = model
    for wd in ("int4", "float32"):
        with pytest.raises(NotImplementedError, match="int8"):
            llama_serving_engine(tp, tcfg, weight_dtype=wd, device="cpu",
                                 max_batch=1, num_pages=8, max_seq=32)


def test_init_serving_blocks(model):
    _, tcfg, _, tp = model
    # a sharded replica is ported (tests/test_torch_serving_tp.py): its
    # mesh needs the ranks of a process group, which this process lacks
    with pytest.raises(ValueError, match="process group"):
        init_serving(tp, tcfg, config={"mesh": {"model": 2}}, device="cpu")
    # the speculative block is ported: the config reaches the engine
    eng = init_serving(tp, tcfg, config={"speculative": {"draft_tokens": 2}},
                       device="cpu", **SERVE)
    assert eng.speculative.enabled and eng.speculative.draft_tokens == 2
    # the telemetry block is ported: the config reaches the engine
    eng = init_serving(tp, tcfg, config={"telemetry": {"enabled": False}},
                       device="cpu", **SERVE)
    assert not eng.registry.enabled
    eng = init_serving(tp, tcfg, weight_dtype="int8", device="cpu",
                       config={"mesh": {"data": 4},
                               "prefix_cache": {},
                               "kernels": {"paged_attention": "xla"}},
                       prefill_chunk=8, **SERVE)
    assert eng._pc_on and eng.kernels.paged_attention == "xla"
    assert isinstance(eng.params["lm_head"], tqz.QuantizedTensor)
    eng.submit("r", [5, 9, 2, 33], max_new_tokens=4)
    assert len(eng.run()["r"]) == 8 and eng.check_leaks() == []
