"""ZeRO-Inference of the port over a sharding mesh (``zero_inference`` with
``mesh``: Llama over ``model`` = 2, bf16-layout weights in f32 and int8,
the NVMe tier; Mixtral over ``expert`` = 2) against the JAX package's
``zero_inference_serving_engine(mesh=)``, on tiny f32 models with f32
caches on both sides.  Two gloo ranks (suite ``zi_tp`` of tests/
_torch_dist.py) are spawned once.

Greedy tokens are identical: against JAX's streamed engine over the same
mesh and against its one-device resident engine (tiny f32 models give
the same tokens whatever the partial sums' order).  Each rank's cache
holds ``n_kv_heads / tp`` heads, and its tier streams only its block of
each layer: the per-rank layer bytes are the rank's blocks (the whole
layer's over tp, plus the replicated norm gains)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from deepspeed_tpu.inference.serving import (llama_serving_engine as
                                             jax_llama_engine,
                                             mixtral_serving_engine as
                                             jax_mixtral_engine)
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.models import mixtral as jm
from deepspeed_tpu.topology import MeshSpec as JMesh

torch.set_num_threads(1)
PROMPTS = {"a": ([5, 9, 2], 6), "b": ([17, 3, 3, 8, 1], 5),
           "c": ([40, 2], 7)}
KW = dict(max_batch=2, page_size=8, num_pages=32, max_seq=64,
          prefill_bucket=8)


@functools.lru_cache(maxsize=None)
def _inputs():
    cfg = jl.LlamaConfig.tiny(dim=64, n_layers=2, n_heads=4, n_kv_heads=2)
    mcfg = jm.MixtralConfig.tiny(attn_impl="reference")
    return (cfg, jax.device_get(jl.init_params(jax.random.PRNGKey(0), cfg)),
            mcfg, jax.device_get(jm.init_params(jax.random.PRNGKey(0),
                                                mcfg)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    _, jp, _, mp = _inputs()
    d = str(tmp_path_factory.mktemp("zi_tp"))
    return td.run_ranks("zi_tp", 2, {"prompts": PROMPTS, "kw": KW,
                                     "dir": d},
                        {"llama": jp, "mixtral": mp})


def _tokens(eng):
    for rid, (p, n) in PROMPTS.items():
        eng.submit(rid, p, max_new_tokens=n)
    res = eng.run()
    return {rid: [int(t) for t in res[rid]] for rid in PROMPTS}


@functools.lru_cache(maxsize=None)
def _jax(family, mesh_axis=None, **extra):
    from deepspeed_tpu.topology import set_current_mesh

    cfg, jp, mcfg, mp = _inputs()
    build, c, p = ((jax_llama_engine, cfg, jp) if family == "llama"
                   else (jax_mixtral_engine, mcfg, mp))
    kw = dict(KW, cache_dtype=jnp.float32, **extra)
    if mesh_axis is not None:
        kw["mesh"] = JMesh.build({mesh_axis: 2}, devices=jax.devices()[:2])
        kw["zero_inference"] = {"enabled": True}
    try:
        return _tokens(build(jax.tree.map(jnp.asarray, p), c, **kw))
    finally:
        set_current_mesh(None)


def _rank_tokens(o, name):
    return {rid: o[f"{name}/{rid}"].tolist() for rid in PROMPTS}


@pytest.mark.parametrize("name", ["bf16", "nvme"])
def test_llama_over_model_matches_jax(ranks, name):
    want = _jax("llama", "model")
    assert want == _jax("llama")
    for o in ranks:
        assert _rank_tokens(o, name) == want
        assert int(o[f"{name}/heads"]) == 1


def test_int8_over_model_matches_jax(ranks):
    want = _jax("llama", "model", weight_dtype="int8", quant_group_size=16)
    assert want == _jax("llama", weight_dtype="int8", quant_group_size=16)
    for o in ranks:
        assert _rank_tokens(o, "int8") == want


def test_each_rank_streams_its_blocks(ranks):
    cfg, jp, _, _ = _inputs()
    blocks = jp["blocks"]
    whole = sum(a[0].size * 4 for a in jax.tree.leaves(blocks))
    norms = sum(blocks[k][0].size * 4 for k in ("attn_norm", "mlp_norm"))
    for o in ranks:
        assert int(o["bf16/layer_bytes"]) == (whole - norms) // 2 + norms
        assert int(o["bf16/uploaded"]) > 0


def test_mixtral_over_expert_matches_jax(ranks):
    want = _jax("mixtral", "expert")
    assert want == _jax("mixtral")
    _, _, mcfg, mp = _inputs()
    per_expert = sum(mp["blocks"][k][0].size * 4 for k in ("w1", "w2", "w3"))
    for o in ranks:
        assert _rank_tokens(o, "moe") == want
        # half the experts a rank; the rest of the layer whole
        rest = sum(a[0].size * 4 for a in jax.tree.leaves(mp["blocks"])) \
            - per_expert
        assert int(o["moe/layer_bytes"]) == rest + per_expert // 2
