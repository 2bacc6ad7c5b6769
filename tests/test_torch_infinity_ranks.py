"""The port's ZeRO-Infinity engine over several gloo ranks, held to the JAX
package's (JAX's ``scenario_infinity`` of tests/mp_child.py: a tiny bf16
Llama, dim 64, 2 layers, 4/2 heads, 8 rows of 33 tokens, 2 steps, the RAM
tier).

One launch at W = 2 (suite ``infinity`` of tests/_torch_dist.py) runs the
device update, the host update and the NVMe tier in the ``[dp, chunk]``
layout, a checkpoint round trip, and the model-parallel engine over
``model`` = 2 (``param_specs``).  Against the JAX single-process engine on
its 8-device mesh: the losses within 2e-3 relative (bf16 forwards of two
frameworks, tests/test_torch_infinity.py's tolerance), the gathered
``master_params()`` updates within 20 % of their norm and their digest
(the sum of absolute values, JAX's) within 1e-4; the model-parallel engine
against JAX's with the same specs on a ``model`` = 2 mesh.  Within the
port: both ranks return the same whole masters, each rank's tier holds
only its row (half the state), the NVMe tier (a subdir a process) equals
the RAM tier bit for bit, and a loaded checkpoint continues the run
exactly."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
import deepspeed_tpu as dstpu
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.topology import MeshSpec

torch.set_num_threads(1)
CFG = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2)
LOSS_RTOL = 2e-3
UPDATE_RTOL = 0.2


def _tokens(cfg):
    return np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 33)).astype(np.int32)


@pytest.fixture(scope="module")
def model():
    cfg = jl.LlamaConfig.tiny(**CFG)
    return cfg, jax.device_get(jl.init_params(jax.random.PRNGKey(0), cfg))


@pytest.fixture(scope="module")
def ranks(model, tmp_path_factory):
    cfg, jp = model
    d = str(tmp_path_factory.mktemp("infinity_ranks"))
    return td.run_ranks("infinity", 2, {"dir": d},
                        {"llama": jp, "tokens": _tokens(cfg)})


@functools.lru_cache(maxsize=None)
def _jax(case):
    cfg = jl.LlamaConfig.tiny(**CFG)
    params = jl.init_params(jax.random.PRNGKey(0), cfg)
    kw = {}
    if case == "tp":
        kw = dict(param_specs=jl.param_specs(cfg),
                  mesh=MeshSpec.build({"model": 2},
                                      devices=jax.devices()[:2]))
    eng = dstpu.initialize(
        loss_fn=jl.loss_fn(cfg), params=params,
        config={"train_batch_size": 8,
                "zero_optimization": {"stage": 3, "offload_optimizer": {
                    "device": "cpu", "scheduled": True}},
                "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
                "bf16": {"enabled": True}}, **kw)[0]
    batch = {"tokens": jnp.asarray(_tokens(cfg))}
    losses = [float(eng.train_batch(batch)) for _ in range(2)]
    if case == "tp":
        from deepspeed_tpu.topology import set_current_mesh

        set_current_mesh(None)
    return np.asarray(losses), jax.device_get(eng.master_params())


def _check(res, name, case, init):
    want, master = _jax(case)
    np.testing.assert_allclose(res[f"{name}/losses"], want, rtol=LOSS_RTOL)
    digest = 0.0
    for path, a in jax.tree_util.tree_flatten_with_path(master)[0]:
        key = f"{name}/master/" + "/".join(str(k.key) for k in path)
        b = res[key]
        w0 = init
        for k in path:
            w0 = w0[k.key]
        w0 = np.asarray(w0, np.float32)
        dj, dt = np.asarray(a) - w0, b - w0
        assert np.linalg.norm(dt - dj) <= UPDATE_RTOL * np.linalg.norm(dj), \
            key
        digest += float(np.abs(b).sum())
    np.testing.assert_allclose(
        digest, float(sum(np.abs(a).sum() for a in jax.tree.leaves(master))),
        rtol=1e-4)


@pytest.mark.parametrize("name", ["device", "host"])
def test_two_ranks_match_jax(ranks, model, name):
    for r in range(2):
        _check(ranks[r], name, "dp", model[1])
        for k in ranks[r]:
            if k.startswith(f"{name}/"):
                np.testing.assert_array_equal(ranks[r][k], ranks[0][k])


def test_each_rank_holds_its_row(ranks, model):
    sizes = [a.size for a in jax.tree.leaves(model[1])]
    chunks = [-(-n // (2 * 128)) * 128 for n in sizes]
    assert int(ranks[0]["device/tier_bytes"]) == 12 * sum(chunks)


def test_nvme_equals_ram_and_checkpoint_round_trips(ranks):
    for r in range(2):
        for k in ranks[r]:
            if k.startswith("device/") and not k.endswith("tier_bytes"):
                np.testing.assert_array_equal(
                    ranks[r][k.replace("device/", "nvme/", 1)], ranks[r][k],
                    err_msg=k)
        a, b = ranks[r]["ckpt/pair"]
        assert a == b
    assert list(ranks[0]["nvme/dirs"]) == ["proc0", "proc1"]


def test_param_specs_over_model_match_jax(ranks, model):
    for r in range(2):
        _check(ranks[r], "tp", "tp", model[1])
