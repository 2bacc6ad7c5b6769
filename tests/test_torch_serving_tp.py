"""Tensor-parallel serving of the port (``mesh`` over ``model`` in
``llama_serving_engine`` / ``init_serving``, ``init_inference(mesh=,
param_specs=)``, int8 weights and the int8 wire over the mesh) against the
JAX package: exact tokens on an f32 tiny Llama (tests/test_serving_tp.py),
with f32 caches on both sides.  Two gloo ranks (model 2) are spawned once
by ``tests/_torch_dist.py``; the JAX oracle is its single-device engine,
which its own TP test holds equal to the TP engine."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from deepspeed_tpu.inference import engine as jie
from deepspeed_tpu.inference.serving import llama_serving_engine as jserve
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.topology import MeshSpec as JMesh

torch.set_num_threads(1)
PROMPTS = {"a": ([5, 9, 2], 6), "b": ([17, 3, 3, 8, 1], 5),
           "c": ([40, 2], 7)}
KW = dict(max_batch=2, page_size=8, num_pages=32, max_seq=64,
          prefill_bucket=8)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
# int8 forwards compute in bf16 (the dequantized leaves' dtype): the bound
# of tests/test_torch_quantized_inference.py's init_inference logits
BF16_ATOL = dict(rtol=0, atol=0.06)


@functools.lru_cache(maxsize=None)
def _inputs():
    cfg = jl.LlamaConfig.tiny(dim=64, n_layers=2, n_heads=4, n_kv_heads=2)
    jp = jax.device_get(jl.init_params(jax.random.PRNGKey(0), cfg))
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 9))
    return cfg, jp, toks.astype(np.int32)


# int8-resident pages (kv_tier.quantized_resident) under TP: held to the
# port's own unsharded int8-resident engine (the JAX engine is no oracle
# for it, ROADMAP C-f2)
KVQ = dict(prefix_cache={}, num_pages=48,
           kv_tier={"demote_watermark": 0.0, "quantize_cold": True,
                    "quantized_resident": True})


def _waves(seed=5, n=3):
    """Two waves of prompts sharing a 20-token prefix."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 256, 20).tolist()
    return [{f"{w}{i}": shared + rng.integers(1, 256, int(rng.integers(
        2, 9))).tolist() for i in range(n)} for w in ("a", "b")]


@pytest.fixture(scope="module")
def ranks():
    _, jp, toks = _inputs()
    return td.run_ranks("serve_tp", 2, {"prompts": PROMPTS, "kw": KW,
                                        "kvq": KVQ, "waves": _waves()},
                        {"llama": jp, "fwd_tokens": toks})


def _jax_tokens(**extra):
    cfg, jp, _ = _inputs()
    eng = jserve(jax.tree.map(jnp.asarray, jp), cfg,
                 cache_dtype=jnp.float32, **dict(KW, **extra))
    for rid, (p, n) in PROMPTS.items():
        eng.submit(rid, p, max_new_tokens=n)
    res = eng.run()
    return {rid: [int(t) for t in res[rid]] for rid in PROMPTS}


def _rank_tokens(o, name):
    return {rid: o[f"{name}/{rid}"].tolist() for rid in PROMPTS}


@pytest.mark.parametrize("name,extra", [
    ("tp", {}), ("split", dict(prefill_chunk=4, decode_chunk=2)),
    ("init_serving", {})])
def test_tp_serving_tokens_match_jax(ranks, name, extra):
    want = _jax_tokens(**extra)
    for o in ranks:
        assert _rank_tokens(o, name) == want
    # each rank's cache holds n_kv_heads / tp heads
    assert all(o["tp/cache_heads"] == 1 for o in ranks)


def test_int8_tp_matches_unsharded_int8(ranks):
    want = _jax_tokens(weight_dtype="int8", quant_group_size=16)
    for o in ranks:
        assert _rank_tokens(o, "int8") == want
    # the codes and group scales of wq are the unsharded ones, cut by
    # columns (the JAX engine's quantized leaf sharded over model)
    cfg, jp, _ = _inputs()
    from deepspeed_tpu.inference.quantized import quantize_params

    q = quantize_params(jax.tree.map(jnp.asarray, jp), group_size=16,
                        skip_paths=("attn_norm", "mlp_norm", "final_norm"))
    wq = q["blocks"]["wq"]
    for m, o in enumerate(ranks):
        cols = wq.q.shape[-1] // 2
        np.testing.assert_array_equal(
            o["int8/wq_q"], np.asarray(wq.q)[..., m * cols:(m + 1) * cols])
        g = wq.scale.shape[-1] // 2
        np.testing.assert_array_equal(
            o["int8/wq_scale"],
            np.asarray(wq.scale)[..., m * g:(m + 1) * g])


def test_int8_wire_placement_matches_jax(ranks):
    cfg, jp, _ = _inputs()
    want = _jax_tokens(mesh=JMesh.build({"model": 2},
                                        devices=jax.devices()[:2]),
                       comm={"quantized_serving": True,
                             "serving_rtol": 0.05})
    from deepspeed_tpu.topology import set_current_mesh

    set_current_mesh(None)
    for o in ranks:
        assert _rank_tokens(o, "wire") == want
        quantized, exact = o["wire/stats"]
        assert quantized > 0 and exact > 0
    # each rank's blocks are the JAX codec's dequantized whole leaves,
    # cut to the rank's columns
    from deepspeed_tpu.comm.collectives import quantize_for_wire_np

    a = np.asarray(jp["blocks"]["w1"])
    q, s, _ = quantize_for_wire_np(a)
    deq = (q.astype(np.float32).reshape(s.size, -1)
           * s[:, None]).reshape(a.shape)
    cols = a.shape[-1] // 2
    for m, o in enumerate(ranks):
        np.testing.assert_array_equal(o["wire/params/blocks/w1"],
                                      deq[..., m * cols:(m + 1) * cols])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_init_inference_over_the_mesh_matches_jax(ranks, dtype):
    cfg, jp, toks = _inputs()
    eng = jie.init_inference(apply_fn=functools.partial(jl.forward, cfg=cfg),
                             params=jax.tree.map(jnp.asarray, jp),
                             dtype=dtype)
    want = np.asarray(eng(jnp.asarray(toks)))
    tol = LOGIT_TOL if dtype == "float32" else BF16_ATOL
    for o in ranks:
        np.testing.assert_allclose(o[f"ie_{dtype}/logits"], want, **tol)
    np.testing.assert_array_equal(ranks[0][f"ie_{dtype}/logits"],
                                  ranks[1][f"ie_{dtype}/logits"])


def test_indivisible_kv_heads_refused(ranks):
    for o in ranks:
        assert "divisible" in str(o["refused"])


def _unsharded_kvq():
    from deepspeed_tpu_torch.inference.serving import llama_serving_engine
    from deepspeed_tpu_torch.models import llama as tl
    from deepspeed_tpu_torch.weights import from_jax_params

    _, jp, _ = _inputs()
    eng = llama_serving_engine(
        from_jax_params(jp, device="cpu"),
        tl.LlamaConfig.tiny(dim=64, n_layers=2, n_heads=4, n_kv_heads=2),
        device="cpu", cache_dtype=torch.float32, **dict(KW, **KVQ))
    toks = {}
    for i, wave in enumerate(_waves()):
        if i:
            eng.step()
        for rid, p in wave.items():
            eng.submit(rid, p, max_new_tokens=8)
        toks.update({rid: [int(t) for t in r]
                     for rid, r in eng.run().items()})
    return eng, toks


def test_int8_resident_kv_under_tp_matches_unsharded(ranks):
    """Each rank's int8 pages are the unsharded int8-resident cache's
    slice of its KV heads: layer 0 (whose input is the same on both)
    code for code and scale for scale; the later layers read a residual
    whose row-parallel sums were reduced over ranks, so their codes agree
    within one step and their scales at 1e-5.  Tokens are identical, the
    warm pages demote and promote through each rank's host tier, which
    holds that rank's heads."""
    eng, want = _unsharded_kvq()
    assert eng.kv_tier_quant_resident_promotes > 0
    for m, o in enumerate(ranks):
        got = {k[len("kvq/tok/"):]: o[k].tolist() for k in o
               if k.startswith("kvq/tok/")}
        assert got == want
        demoted, promoted, qpromotes, hits = o["kvq/counts"]
        assert demoted > 0 and promoted > 0 and qpromotes > 0 and hits > 0
        assert o["kvq/tier_page_shape"][1] == 1        # 2 KV heads / 2
        for name in ("k", "v", "k_scale", "v_scale"):
            whole = getattr(eng.cache, name).numpy()
            mine = whole[:, m:m + 1]
            assert o[f"kvq/{name}"].shape == mine.shape
            np.testing.assert_array_equal(o[f"kvq/{name}"][0], mine[0])
            if name in ("k", "v"):
                assert np.abs(o[f"kvq/{name}"].astype(np.int32)
                              - mine.astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(o[f"kvq/{name}"], mine,
                                           rtol=1e-5)
