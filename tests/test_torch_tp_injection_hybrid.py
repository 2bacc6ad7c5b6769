"""Tensor parallelism through the port's injection and hybrid engine, and
an elastic batch at world 2, against the JAX package and one rank.

``inject`` returns the family's ``param_specs`` (JAX's trees, leaf for
leaf), so an injected model serves over ``model`` through
``init_inference(mesh=, param_specs=specs)``; ``init_hybrid_engine`` with
``inference_tp_size`` equal to the mesh's ``model`` size generates from the
training layout, and any other size raises with JAX's wording.  Two gloo
ranks (``tests/_torch_dist.py`` suite ``inj_hybrid``) run it; the oracles
are one rank of the port in this process (f32: logits at 1e-5, greedy
tokens identical, the step's loss at 1e-5) and the JAX package for the
spec trees, the refusal and the elastic batch.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_dist as td
import deepspeed_tpu as dstpu
from deepspeed_tpu.config import Config as JConfig
from deepspeed_tpu.inference import injection as jinj
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.models import mixtral as jm
from deepspeed_tpu_torch import (init_hybrid_engine, initialize, inject,
                                 topology)
from deepspeed_tpu_torch.inference import injection as tinj
from deepspeed_tpu_torch.models import llama as tl
from test_torch_hf import _mixtral_hf, _mixtral_hf_config

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
HYBRID_CONF = {"train_batch_size": 8, "bf16": {"enabled": False},
               "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
               "hybrid_engine": {"enabled": True, "inference_tp_size": 2,
                                 "max_out_tokens": 64}}
ELASTIC_CONF = {"bf16": {"enabled": False},
                "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
                "elasticity": {"enabled": True, "max_train_batch_size": 8,
                               "micro_batch_sizes": [1, 2], "min_gpus": 1,
                               "max_gpus": 4}}


@functools.lru_cache(maxsize=None)
def _inputs():
    cfg = jl.LlamaConfig.tiny()
    jp = jax.device_get(jl.init_params(jax.random.PRNGKey(0), cfg))
    mcfg = jm.MixtralConfig.tiny()
    sd = _mixtral_hf(mcfg)
    rng = np.random.default_rng(11)
    return {"cfg": cfg, "jp": jp, "mcfg": mcfg, "sd": sd,
            "toks": rng.integers(0, 256, (2, 10)).astype(np.int32),
            "prompts": rng.integers(0, 256, (4, 6)).astype(np.int32),
            "train": rng.integers(0, 256, (8, 13)).astype(np.int32),
            "elastic": rng.integers(0, 256, (16, 13)).astype(np.int32)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    x = _inputs()
    spec = {"dir": str(tmp_path_factory.mktemp("inj")),
            "mixtral_hf": _mixtral_hf_config(x["mcfg"]),
            "hybrid_conf": HYBRID_CONF, "elastic_conf": ELASTIC_CONF}
    return td.run_ranks("inj_hybrid", 2, spec, {
        "llama": x["jp"], "mixtral_sd": x["sd"], "fwd_tokens": x["toks"],
        "prompts": x["prompts"], "train_tokens": x["train"],
        "elastic_tokens": x["elastic"]}, timeout=200)


def _one_rank():
    return topology.MeshSpec(sizes={a: 1 for a in topology.AXES})


def _specs_tuple(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


@pytest.mark.parametrize("arch", ["llama", "LlamaForCausalLM", "mixtral",
                                  "MixtralForCausalLM"])
def test_inject_spec_trees_equal_jax(arch):
    x = _inputs()
    hf = (_mixtral_hf_config(x["mcfg"]) if "ixtral" in arch else
          {"hidden_size": 64, "num_hidden_layers": 2,
           "num_attention_heads": 4, "num_key_value_heads": 2,
           "vocab_size": 256})
    _, _, cfg, specs = inject(arch, hf)
    _, _, _, want = jinj.inject(arch, hf)
    assert specs == _specs_tuple(want)
    assert specs == tinj.get_policy(arch).param_specs(cfg)


def test_injected_llama_over_model_equals_one_rank(ranks):
    x = _inputs()
    from deepspeed_tpu_torch.weights import from_jax_params

    want = tl.forward(from_jax_params(x["jp"], device="cpu"),
                      torch.from_numpy(x["toks"]), tl.LlamaConfig.tiny())
    for o in ranks:
        assert int(o["llama/wq_cols"]) == 64 // 2
        np.testing.assert_allclose(o["llama/logits"], want.numpy(), **TOL)
        assert (o["llama/logits"].argmax(-1)
                == want.numpy().argmax(-1)).all()


@pytest.mark.parametrize("axis", ["model", "expert"])
def test_injected_mixtral_over_the_mesh_equals_one_rank(ranks, axis):
    x = _inputs()
    fn, p, _, _ = inject("MixtralForCausalLM", _mixtral_hf_config(x["mcfg"]),
                         {k: torch.from_numpy(v) for k, v in x["sd"].items()},
                         dtype=torch.float32, device="cpu")
    want = fn(p, torch.from_numpy(x["toks"])).numpy()
    for o in ranks:
        np.testing.assert_allclose(o[f"mixtral_{axis}/logits"], want, **TOL)
        assert (o[f"mixtral_{axis}/logits"].argmax(-1)
                == want.argmax(-1)).all()


def test_hybrid_over_model_generates_the_one_rank_tokens(ranks):
    x = _inputs()
    from deepspeed_tpu_torch.weights import from_jax_params

    cfg = tl.LlamaConfig.tiny()
    conf = dict(HYBRID_CONF, hybrid_engine=dict(
        HYBRID_CONF["hybrid_engine"], inference_tp_size=0))
    eng = initialize(loss_fn=tl.loss_fn(cfg),
                     params=from_jax_params(x["jp"], device="cpu"),
                     config=conf, device="cpu", dist_init_required=False,
                     mesh=_one_rank())[0]
    hyb = init_hybrid_engine(eng, cfg, cache_dtype=torch.float32)
    prompts = torch.from_numpy(x["prompts"])
    before = hyb.generate(prompts, max_new_tokens=6, temperature=0.0)
    loss = float(hyb.train_batch({"tokens": torch.from_numpy(x["train"])}))
    after = hyb.generate(prompts, max_new_tokens=6, temperature=0.0)
    for o in ranks:
        assert int(o["hybrid/cache_heads"]) == cfg.n_kv_heads // 2
        np.testing.assert_array_equal(o["hybrid/before"], before.numpy())
        np.testing.assert_array_equal(o["hybrid/after"], after.numpy())
        np.testing.assert_allclose(o["hybrid/loss"], loss, **TOL)


def test_hybrid_tp_size_other_than_the_mesh_raises_as_jax(ranks):
    from deepspeed_tpu.topology import MeshSpec as JMesh

    cfg = jl.LlamaConfig.tiny()
    jmesh = JMesh.build({"model": 2}, devices=jax.devices()[:2])
    conf = dict(HYBRID_CONF, mesh={"model": 2}, hybrid_engine=dict(
        HYBRID_CONF["hybrid_engine"], inference_tp_size=4))
    je, _, _, _ = dstpu.initialize(
        loss_fn=jl.loss_fn(cfg),
        params=jl.init_params(jax.random.PRNGKey(0), cfg), config=conf,
        mesh=jmesh, param_specs=jl.param_specs(cfg))
    with pytest.raises(ValueError) as want:
        dstpu.init_hybrid_engine(je, cfg)
    from deepspeed_tpu.topology import set_current_mesh

    set_current_mesh(None)
    got = str(ranks[0]["hybrid/refused"])
    assert got == str(want.value).replace("the TPU hybrid engine",
                                          "the hybrid engine")


def test_elastic_batch_at_world_two_matches_jax(ranks):
    want = JConfig.from_dict(ELASTIC_CONF)
    want.resolve_batch_sizes(2)
    batch = [want.train_batch_size, want.train_micro_batch_size_per_gpu,
             want.gradient_accumulation_steps]
    for o in ranks:
        assert o["elastic/batch"].tolist() == batch
        t, m, a = batch
        assert m * a * 2 == t
        assert np.isfinite(o["elastic/loss"])
    assert ranks[0]["elastic/loss"] == ranks[1]["elastic/loss"]
