"""Tensor parallelism of the port (``parallel/tensor_parallel.py``, the
``model`` axis of ``zero`` / ``engine`` / ``models/llama.py`` and
``checkpoint.py`` at tp > 1) against the JAX package.

Gloo ranks (W = 2: model 2; W = 4: data 2 x model 2) are spawned once by
``tests/_torch_dist.py`` and train tiny f32 Llama for 3 steps under
``llama.param_specs`` at every ZeRO stage; the JAX engine on the same mesh
of its 8 virtual CPU devices, with the same bridged weights and tokens, is
the oracle at the JAX TP test's tolerance, 5e-3 (tests/test_models.py:82).
The stage-0 checkpoint the ranks write is read back into a TP engine of
another stage (bit for bit) and into one rank in this process.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_dist as td
import deepspeed_tpu as dstpu
from deepspeed_tpu import zero as jzero
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.parallel import tensor_parallel as jtp
from deepspeed_tpu.topology import MeshSpec as JMesh
from deepspeed_tpu_torch import initialize, topology, zero
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.parallel import tensor_parallel as ttp

torch.set_num_threads(1)
TP_TOL = dict(rtol=5e-3, atol=5e-3)      # tests/test_models.py:82
STEPS = 3
STAGES = {"2": [0, 1], "4": [0, 1, 2, 3]}
CKPT_STAGE = 1


@functools.lru_cache(maxsize=None)
def _inputs():
    cfg = jl.LlamaConfig.tiny()
    jp = jax.device_get(jl.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (STEPS, 8, 17)).astype(np.int32)
    return cfg, jp, tokens


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import concurrent.futures as cf

    _, jp, tokens = _inputs()
    d = str(tmp_path_factory.mktemp("tp_ckpt"))
    spec = {"stages": STAGES, "ckpt_stage": CKPT_STAGE, "dir": d}
    with cf.ThreadPoolExecutor(2) as ex:
        futs = {W: ex.submit(td.run_ranks, "tp", W, spec,
                             {"llama": jp, "tokens": tokens})
                for W in (2, 4)}
        return {W: f.result() for W, f in futs.items()}, d


def _specs_tuple(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


@functools.lru_cache(maxsize=None)
def _jax_run(W, stage):
    cfg, jp, tokens = _inputs()
    sizes = {"model": 2} if W == 2 else {"data": 2, "model": 2}
    conf = {"train_batch_size": 8, "bf16": {"enabled": False},
            "gradient_clipping": 1.0, "mesh": sizes,
            "zero_optimization": {"stage": stage},
            "optimizer": {"type": "adamw",
                          "params": {"lr": 3e-3, "weight_decay": 0.1}}}
    mesh = JMesh.build(sizes, devices=jax.devices()[:W])
    eng, _, _, _ = dstpu.initialize(
        loss_fn=jl.loss_fn(cfg), params=jax.tree.map(jnp.asarray, jp),
        config=conf, mesh=mesh, param_specs=jl.param_specs(cfg))
    rows = []
    for i in range(STEPS):
        loss = float(eng.train_batch({"tokens": jnp.asarray(tokens[i])}))
        rows.append([loss, eng.get_global_grad_norm()])
    return np.asarray(rows), jax.device_get(eng.module_params())


@pytest.mark.parametrize("W,stage", [(2, 0), (2, 1), (4, 0), (4, 1), (4, 2),
                                     (4, 3)])
def test_tp_training_matches_jax_engine(runs, W, stage):
    res, _ = runs
    want, jp = _jax_run(W, stage)
    got = res[W][0][f"stage{stage}/trace"]
    for r in range(1, W):
        np.testing.assert_array_equal(res[W][r][f"stage{stage}/trace"], got)
    np.testing.assert_allclose(got[:, :2], want, **TP_TOL)
    for k, v in td._flatten(jp).items():
        np.testing.assert_allclose(res[W][0][f"stage{stage}/params/{k}"], v,
                                   err_msg=k, **TP_TOL)


def test_tp_checkpoint_round_trip(runs):
    res, d = runs
    for W in (2, 4):
        saved = td.unflatten(res[W][0], "ckpt/saved/")
        back = td.unflatten(res[W][0], "ckpt/params/")
        for k, v in td._flatten(saved).items():
            np.testing.assert_array_equal(td._flatten(back)[k], v, err_msg=k)
        nxt = res[W][0]["ckpt/next"]
        assert nxt[0] == nxt[1]
        # the stage-0 layout: one rank reads the whole leaves
        cfg, jp, _ = _inputs()
        one = initialize(loss_fn=tl.loss_fn(cfg),
                         params=td._tree_params({f"l/{k}": v for k, v in
                                                 td._flatten(jp).items()},
                                                "l"),
                         config={"train_batch_size": 8,
                                 "bf16": {"enabled": False},
                                 "optimizer": {"type": "adamw"}},
                         device="cpu", dist_init_required=False,
                         mesh=topology.MeshSpec(
                             sizes={a: 1 for a in topology.AXES}))[0]
        one.load_checkpoint(f"{d}/w{W}")
        got = {k: td._np(v) for k, v in
               td._flatten(one.module_params()).items()}
        for k, v in td._flatten(saved).items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_megatron_mappings(runs):
    res, _ = runs
    r2 = res[2]
    x = np.arange(6.0).reshape(2, 3)
    for m in range(2):
        o = r2[m]
        # copy_to: identity forward, backward all-reduced (1 + 2)
        np.testing.assert_array_equal(o["copy_to/y"], x * (m + 1))
        np.testing.assert_array_equal(o["copy_to/g"], np.full((2, 3), 3.0))
        # reduce_from: all-reduced forward, identity backward
        np.testing.assert_array_equal(o["reduce_from/y"], x * 3)
        np.testing.assert_array_equal(o["reduce_from/g"],
                                      np.full((2, 3), m + 1.0))
        # gather_from: features gathered, own slice of the cotangent back
        want = np.concatenate([np.arange(4.0).reshape(2, 2) + 10 * j
                               for j in range(2)], axis=1)
        np.testing.assert_array_equal(o["gather_from/y"], want)
        np.testing.assert_array_equal(
            o["gather_from/g"], np.arange(8.0).reshape(2, 4)[:, 2 * m:
                                                             2 * m + 2])
        # scatter_to: own slice forward, cotangents gathered back
        np.testing.assert_array_equal(
            o["scatter_to/y"], np.arange(8.0).reshape(2, 4)[:, 2 * m:
                                                            2 * m + 2])
        np.testing.assert_array_equal(
            o["scatter_to/g"], np.repeat([[1.0, 1.0, 2.0, 2.0]], 2, 0))


def test_spec_builders_match_jax():
    for stacked in (False, True):
        for nd in (2, 3):
            assert ttp.column_parallel(nd, stacked=stacked) == tuple(
                jtp.column_parallel(nd, stacked=stacked))
            assert ttp.row_parallel(nd, stacked=stacked) == tuple(
                jtp.row_parallel(nd, stacked=stacked))
    assert ttp.vocab_parallel_embedding() == tuple(
        jtp.vocab_parallel_embedding())
    cfg = jl.LlamaConfig.tiny()
    for pipe in (False, True):
        assert tl.param_specs(tl.LlamaConfig.tiny(), pipeline=pipe) == \
            _specs_tuple(jl.param_specs(cfg, pipeline=pipe))
    ms = topology.MeshSpec(sizes={a: {"model": 2}.get(a, 1)
                                  for a in topology.AXES})
    assert ttp.tp_degree(ms) == 2
    assert ttp.head_sharding_ok(4, ms) and not ttp.head_sharding_ok(3, ms)


def test_zero_specs_layer_data_onto_tp_specs():
    """ZeRO's data axis on top of the TP specs, as tests/test_zero_specs.py
    lays it on a {"data": 4, "model": 2} mesh."""
    cfg, jp, _ = _inputs()
    jms = JMesh.build({"data": 4, "model": 2})
    tms = topology.MeshSpec(sizes={a: {"data": 4, "model": 2}.get(a, 1)
                                   for a in topology.AXES})
    tp = td._tree_params({f"l/{k}": v for k, v in td._flatten(jp).items()},
                         "l")
    for stage in (0, 1, 3):
        want = jax.tree_util.tree_leaves(
            jzero.param_shardings(jp, jms, stage, jl.param_specs(cfg)),
            is_leaf=lambda s: hasattr(s, "spec"))
        got = _spec_leaves(zero.param_shardings(
            tp, tms, stage, tl.param_specs(tl.LlamaConfig.tiny())))
        assert [tuple(s.spec) for s in want] == got, stage


def _spec_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    return [tree]
