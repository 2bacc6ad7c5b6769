"""ZeRO stages 0-3 of the port across gloo ranks, held to the JAX engine on
the same mesh size (tests/test_zero_engine.py's MLP, f32).

Each world size (1, 2, 4) is one launch of its ranks (tests/_torch_dist.py)
running every case: stages 0-3 for 5 steps, accumulation 2, clipping 0.1,
an fp16 run whose loss scaler skips steps, and an init thunk at stage 3.
Against the JAX engine on ``MeshSpec.build({"data": W})``: losses and
``get_global_grad_norm`` at rtol 1e-5 (f32 sums in another order), params
after the run at the JAX stage test's rtol / atol 2e-3
(tests/test_zero_engine.py), fp16 losses at 1e-2 (tests/test_torch_train.py)
with the same overflow steps and scales (the fp16 exchange carries fp16,
as the reference's and JAX's do).  Rank r's shard of each moment
leaf has the shape of JAX's shard on device r (the same dim) and its
values.  At W = 1 every stage equals stage 0 bit for bit, and a rank of a
one-rank group equals an engine with no process group."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
import deepspeed_tpu as dstpu
from deepspeed_tpu.topology import MeshSpec
from deepspeed_tpu_torch import initialize, topology, zero

torch.set_num_threads(1)
RTOL = 1e-5
PARAM_TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture(scope="module")
def runs():
    import concurrent.futures as cf

    with cf.ThreadPoolExecutor(3) as ex:
        futs = {W: ex.submit(td.run_ranks, "stages", W) for W in (1, 2, 4)}
        return {W: f.result() for W, f in futs.items()}


def _jloss(params, batch):
    x, y = batch["x"], batch["y"]
    h = jnp.tanh(x @ params["w1"].astype(x.dtype)
                 + params["b1"].astype(x.dtype))
    logits = (h @ params["w2"].astype(x.dtype)
              + params["b2"].astype(x.dtype)).astype(jnp.float32)
    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))


BASE = {"train_batch_size": 32, "bf16": {"enabled": False},
        "optimizer": {"type": "adam", "params": {"lr": 1e-2}}}
CASES = {
    **{f"stage{s}": (dict(BASE, zero_optimization={"stage": s}), 5)
       for s in range(4)},
    "accum": (dict(BASE, gradient_accumulation_steps=2,
                   zero_optimization={"stage": 2}), 5),
    "clip": (dict(BASE, gradient_clipping=0.1,
                  zero_optimization={"stage": 3}), 5),
    "fp16": (dict(BASE, fp16={"enabled": True, "initial_scale_power": 20,
                              "loss_scale_window": 2},
                  zero_optimization={"stage": 2}), 8),
}


@functools.lru_cache(maxsize=None)
def _jax_run(W, name):
    conf, steps = CASES[name]
    mesh = MeshSpec.build({"data": W}, devices=jax.devices()[:W])
    eng, _, _, _ = dstpu.initialize(
        loss_fn=_jloss, params=jax.tree.map(jnp.asarray, td.mlp_params()),
        config=dict(conf), mesh=mesh)
    batch = jax.tree.map(jnp.asarray, td.mlp_data())
    rows = []
    for _ in range(steps):
        loss = float(eng.train_batch(batch))
        rows.append([loss, eng.get_global_grad_norm(),
                     int(eng.metrics["overflow"]),
                     float(eng.metrics["loss_scale"])])
    return np.asarray(rows), eng


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_trajectory_matches_jax_engine(runs, W, name):
    want, jeng = _jax_run(W, name)
    res = runs[W]
    for r in range(W):
        got = res[r][f"{name}/trace"]
        # every rank reports the same step
        np.testing.assert_array_equal(got, res[0][f"{name}/trace"])
    got = res[0][f"{name}/trace"]
    np.testing.assert_array_equal(got[:, 2:], want[:, 2:])   # overflow, scale
    rtol = 1e-2 if name == "fp16" else RTOL
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=rtol)
    if name != "fp16":
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=RTOL)
    assert got[-1, 0] < got[0, 0]
    jp = jax.device_get(jeng.module_params())
    for k in jp:
        np.testing.assert_allclose(res[0][f"{name}/params/{k}"], jp[k],
                                   err_msg=k, **PARAM_TOL)


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_moment_shards_are_jax_shards(runs, W, stage):
    """Rank r's shard of each moment leaf: JAX's shard on device r (same
    shape, so the same dim; values at the stage tolerance)."""
    _, jeng = _jax_run(W, f"stage{stage}")
    devs = jax.devices()[:W]
    for k, leaf in jeng.state.opt_state.mu.items():
        shards = {s.device: np.asarray(s.data)
                  for s in leaf.addressable_shards}
        spec = tuple(leaf.sharding.spec)
        d = zero.shard_dim(leaf.shape, W)
        assert ("data" in spec) == (d is not None)
        if d is not None:
            assert spec.index("data") == d
        for r in range(W):
            got = runs[W][r][f"stage{stage}/mu/{k}"]
            assert got.shape == shards[devs[r]].shape, (k, r)
            np.testing.assert_allclose(got, shards[devs[r]], err_msg=k,
                                       **PARAM_TOL)


def test_placements_match_jax_shardings():
    params = td.mlp_params()
    for W in (2, 4):
        tms = topology.MeshSpec(sizes={a: W if a == "data" else 1
                                       for a in topology.AXES})
        jms = MeshSpec.build({"data": W}, devices=jax.devices()[:W])
        from deepspeed_tpu import zero as jzero

        for stage in range(4):
            jp = jzero.param_shardings(params, jms, stage)
            tp = zero.param_shardings(params, tms, stage)
            for k in params:
                want = tuple(jp[k].spec)
                while want and want[-1] is None:
                    want = want[:-1]
                assert tp[k] == want, (W, stage, k)


def test_world_one_every_stage_is_stage0_bit_for_bit(runs):
    res = runs[1][0]
    for name in ("stage1", "stage2", "stage3", "thunk"):
        n = res[f"{name}/trace"].shape[0]
        np.testing.assert_array_equal(res[f"{name}/trace"],
                                      res["stage0/trace"][:n], err_msg=name)
    for s in (1, 2, 3):
        for k in ("w1", "b1", "w2", "b2"):
            np.testing.assert_array_equal(res[f"stage{s}/params/{k}"],
                                          res[f"stage0/params/{k}"])
    # a one-rank gloo group against a lone engine with no process group
    eng = initialize(loss_fn=td._mlp_loss, params=td.mlp_params(),
                     config=dict(CASES["stage0"][0]), device="cpu")[0]
    batch = td.mlp_data()
    losses = [float(eng.train_batch(batch)) for _ in range(5)]
    np.testing.assert_array_equal(losses, res["stage0/trace"][:, 0])


@pytest.mark.parametrize("W", [2, 4])
def test_init_thunk_at_stage3_equals_eager(runs, W):
    for r in range(W):
        n = runs[W][r]["thunk/trace"].shape[0]
        np.testing.assert_array_equal(runs[W][r]["thunk/trace"],
                                      runs[W][r]["stage3/trace"][:n])


@pytest.mark.parametrize("dp,accum", [(2, 2), (4, 2), (4, 1), (3, 2)])
def test_accum_split_is_jax_layout_and_ranks_take_its_rows(dp, accum):
    from deepspeed_tpu import engine as jeng

    x = np.arange(24 * 3).reshape(24, 3).astype(np.float32)
    want = np.asarray(jeng.accum_split({"x": jnp.asarray(x)}, accum, dp)["x"])
    # rank r's microbatch a: the rows JAX's [dp, accum, mb] view gives
    # device r, i.e. its slice of the global microbatch a
    eng = initialize(loss_fn=td._mlp_loss, params=td.mlp_params(),
                     config=dict(BASE, train_batch_size=24), device="cpu")[0]
    mb = 24 // (dp * accum)
    for r in range(dp):
        eng.dp, eng.rank = dp, r
        micro = eng._local_rows({"x": x}, accum)
        for a in range(accum):
            np.testing.assert_array_equal(
                micro[a]["x"].numpy(), want[a][r * mb:(r + 1) * mb])


def test_estimate_memory_matches_jax():
    from deepspeed_tpu import zero as jzero

    for stage in range(4):
        for off in (False, True):
            assert zero.estimate_memory(10 ** 9, 4, stage, off) == \
                jzero.estimate_memory(10 ** 9, 4, stage, off)


def test_sharded_init_places_leaf_by_leaf():
    ms = topology.MeshSpec(sizes={a: 1 for a in topology.AXES})
    got = zero.sharded_init(lambda: {"w": torch.arange(12.).reshape(3, 4)},
                            ms, stage=3, device="cpu", dtype=torch.float64)
    assert got["w"].dtype == torch.float64
    np.testing.assert_array_equal(got["w"].numpy(),
                                  np.arange(12.).reshape(3, 4))
    # param_specs are ported: a None spec is replicated, a spec that is
    # neither a tuple nor None raises
    t = torch.zeros(2, 2)
    assert zero.resolve_specs({"w": t}, param_specs={"w": None}) == {"w": ()}
    assert zero.resolve_specs({"w": t}, param_specs=lambda _: (
        None, "model")) == {"w": (None, "model")}
    with pytest.raises(TypeError, match="spec"):
        zero.resolve_specs({"w": t}, param_specs={"w": "model"})
