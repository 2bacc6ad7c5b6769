"""The port's layer-streaming engine over several gloo ranks, held to the
JAX package's (JAX's ``scenario_pstream`` of tests/mp_child.py: a tiny
bf16 Llama, dim 64, 2 layers, 4/2 heads, 8 rows of 33 tokens, the RAM
tier).

One launch at W = 2 (suite ``pstream`` of tests/_torch_dist.py) runs 3
steps on the RAM tier and on NVMe, saves and resumes the universal
checkpoint, and trains the model-parallel engine over ``model`` = 2
(``param_specs``); a W = 1 launch then loads the W = 2 checkpoint.
Against the JAX single-process stream on its 8-device mesh: losses within
2e-3 relative and the step-3 grad norm within 1e-2 (tests/
test_torch_param_stream.py's tolerances for bf16 forwards of two
frameworks), the gathered masters' updates within 20 % of their norm and
their digest (the sum of absolute values, JAX's) within 1e-4.  The
model-parallel engine is held to JAX's streaming engine with the same
specs on a ``model`` = 2 mesh, at the same tolerances.  Within the port:
every rank reports the same losses and whole masters, the NVMe tier equals
the RAM tier bit for bit (per-process subdirs), a resumed engine's next
loss equals the saving engine's, and the W = 1 load's next loss equals
W = 2's within 1e-5 (the same weights; f32 means over 8 rows or 2 x 4)."""

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
NORM_RTOL = 1e-2
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
    d = str(tmp_path_factory.mktemp("pstream_ranks"))
    inputs = {"llama": jp, "tokens": _tokens(cfg)}
    two = td.run_ranks("pstream", 2, {"dir": d}, inputs)
    one = td.run_ranks("pstream", 1, {"load": f"{d}/w2"}, inputs)
    return two, one


def _conf(**over):
    conf = {"train_batch_size": 8,
            "zero_optimization": {"stage": 3, "offload_param": {
                "device": "cpu", "scheduled": True}},
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "bf16": {"enabled": True}}
    conf.update(over)
    return conf


@functools.lru_cache(maxsize=None)
def _jax(case):
    cfg = jl.LlamaConfig.tiny(**CFG)
    params = jl.init_params(jax.random.PRNGKey(0), cfg)
    kw = {}
    if case == "tp":
        kw = dict(param_specs=jl.param_specs(cfg),
                  mesh=MeshSpec.build({"model": 2},
                                      devices=jax.devices()[:2]))
    eng = dstpu.initialize(params=jl.layered_model(cfg, params),
                           config=_conf(), **kw)[0]
    if case == "tp":
        from deepspeed_tpu.topology import set_current_mesh

        set_current_mesh(None)
    batch = {"tokens": jnp.asarray(_tokens(cfg))}
    losses = [float(eng.train_batch(batch)) for _ in range(3)]
    return (np.asarray(losses), float(eng.get_global_grad_norm()),
            jax.device_get(eng.master_params()))


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _check(res, name, case, init):
    want, norm, master = _jax(case)
    np.testing.assert_allclose(res[f"{name}/losses"], want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(res[f"{name}/norm"], norm, rtol=NORM_RTOL)
    assert res[f"{name}/losses"][-1] < res[f"{name}/losses"][0]
    digest = 0.0
    for path, a in jax.tree_util.tree_flatten_with_path(master)[0]:
        key = f"{name}/master/" + "/".join(str(k.key) for k in path)
        b = res[key]
        w0 = np.asarray(_leaf(init, path), np.float32)
        dj, dt = np.asarray(a) - w0, b - w0
        assert np.linalg.norm(dt - dj) <= UPDATE_RTOL * np.linalg.norm(dj), \
            key
        digest += float(np.abs(b).sum())
    want_digest = float(sum(np.abs(a).sum()
                            for a in jax.tree.leaves(master)))
    np.testing.assert_allclose(digest, want_digest, rtol=1e-4)


def test_two_ranks_match_jax_stream(ranks, model):
    two, _ = ranks
    for r in range(2):
        _check(two[r], "ram", "dp", model[1])
    for k in two[0]:
        if k.startswith("ram/"):
            np.testing.assert_array_equal(two[1][k], two[0][k], err_msg=k)
    # overlap_step is off across processes; each rank holds half a row
    assert not bool(two[0]["ram/overlap"])
    sizes = [int(np.prod(a.shape[1:]))
             for a in jax.tree.leaves(model[1]["blocks"])]
    assert sorted(two[0]["ram/chunks"]) == sorted(-(-n // 2) for n in sizes)


def test_nvme_tier_equals_ram_bit_for_bit(ranks):
    two, _ = ranks
    for r in range(2):
        for k in two[r]:
            if k.startswith("ram/") and k != "ram/overlap" \
                    and k != "ram/chunks":
                np.testing.assert_array_equal(
                    two[r][k.replace("ram/", "nvme/", 1)], two[r][k],
                    err_msg=k)
    assert list(two[0]["nvme/dirs"]) == ["pstream_proc0", "pstream_proc1"]


def test_universal_checkpoint_resumes_at_w2_and_w1(ranks):
    two, one = ranks
    for r in range(2):
        a, b = two[r]["resume/pair"]
        assert a == b
    np.testing.assert_allclose(one[0]["resume/loss"],
                               two[0]["resume/pair"][0], rtol=1e-5)


def test_param_specs_over_model_match_jax(ranks, model):
    two, _ = ranks
    for r in range(2):
        _check(two[r], "tp", "tp", model[1])
