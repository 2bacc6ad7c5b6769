"""ZeRO-Offload of the port at stages 1-3 across gloo ranks (the
unscheduled ``offload_optimizer`` / ``offload_param`` blocks on ``cpu``),
held to the JAX engine with the same blocks on ``MeshSpec.build({"data":
W})`` (tests/test_zero_engine.py's MLP, f32, clipping 1.0).

Each world size (1, 2, 4) is one launch of its ranks (tests/_torch_dist.py,
suite ``offload``): stages 1-3, each without a block and with each of the
three, 5 steps; LAMB at stages 1-3 without and with the optimizer block, 4
steps; at W = 2 stage-2 checkpoints with and without both blocks, which the
W = 1 launch (after it) loads into a stage-3 engine with the optimizer
block.  Against JAX: losses and grad norms at rtol 1e-5, params after the
run at rtol / atol 2e-3 (tests/test_torch_zero_stages.py's tolerances),
LAMB's too.  Within the port, bit for bit at every W: each block's losses,
norms, gathered params and moment shards equal the engine without it; its
master shard equals the slice of the plain engine's whole master; its
checkpoint files equal the plain engine's; the load at W = 1 continues the
W = 2 run's next loss exactly (f32 sums over one rank and two agree here
to the last bit only where they are the same sums, so that loss is held at
rtol 1e-6)."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
import deepspeed_tpu as dstpu
from deepspeed_tpu.topology import MeshSpec
from deepspeed_tpu_torch import zero

torch.set_num_threads(1)
RTOL = 1e-5
PARAM_TOL = dict(rtol=2e-3, atol=2e-3)
BLOCKS = sorted(td.OFFLOAD_BLOCKS)
BASE = {"train_batch_size": 32, "bf16": {"enabled": False},
        "gradient_clipping": 1.0,
        "optimizer": {"type": "adam", "params": {"lr": 1e-2}}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import concurrent.futures as cf

    d = str(tmp_path_factory.mktemp("offload_ck"))
    spec = {"dir": d, "save_w": 2}
    with cf.ThreadPoolExecutor(2) as ex:
        futs = {W: ex.submit(td.run_ranks, "offload", W,
                             spec if W == 2 else {}) for W in (2, 4)}
        out = {W: f.result() for W, f in futs.items()}
    out[1] = td.run_ranks("offload", 1, spec)
    out["dir"] = d
    return out


def _jloss(params, batch):
    x, y = batch["x"], batch["y"]
    h = jnp.tanh(x @ params["w1"] + params["b1"])
    logits = (h @ params["w2"] + params["b2"]).astype(jnp.float32)
    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))


@functools.lru_cache(maxsize=None)
def _jax_run(W, stage, block, opt="adam", steps=5):
    conf = dict(BASE, zero_optimization=dict(stage=stage,
                                             **td.OFFLOAD_BLOCKS.get(block,
                                                                     {})))
    if opt == "lamb":
        conf["optimizer"] = {"type": "lamb",
                             "params": {"lr": 1e-2, "weight_decay": 0.01}}
    mesh = MeshSpec.build({"data": W}, devices=jax.devices()[:W])
    eng = dstpu.initialize(
        loss_fn=_jloss, params=jax.tree.map(jnp.asarray, td.mlp_params()),
        config=conf, mesh=mesh)[0]
    batch = jax.tree.map(jnp.asarray, td.mlp_data())
    rows = []
    for _ in range(steps):
        rows.append([float(eng.train_batch(batch)),
                     eng.get_global_grad_norm()])
    return np.asarray(rows), jax.device_get(eng.module_params())


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("block", BLOCKS)
def test_offload_matches_jax_engine(runs, W, stage, block):
    want, jp = _jax_run(W, stage, block)
    got = runs[W][0][f"s{stage}_{block}/trace"]
    for r in range(W):
        np.testing.assert_array_equal(runs[W][r][f"s{stage}_{block}/trace"],
                                      got)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=RTOL)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=RTOL)
    for k in jp:
        np.testing.assert_allclose(runs[W][0][f"s{stage}_{block}/params/{k}"],
                                   jp[k], err_msg=k, **PARAM_TOL)


@pytest.mark.parametrize("W", [1, 2, 4])
@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("block", BLOCKS)
def test_offload_equals_plain_bit_for_bit(runs, W, stage, block):
    params = td.mlp_params()
    for r in range(W):
        res = runs[W][r]
        off, plain = f"s{stage}_{block}", f"s{stage}_plain"
        np.testing.assert_array_equal(res[f"{off}/trace"],
                                      res[f"{plain}/trace"])
        for k in params:
            np.testing.assert_array_equal(res[f"{off}/params/{k}"],
                                          res[f"{plain}/params/{k}"])
        for key in res:
            if key.startswith(f"{off}/bytes/opt/"):
                np.testing.assert_array_equal(
                    res[key], res[key.replace(off, plain)], err_msg=key)
        # every block places the master on the host as this rank's shard,
        # so at stages 1-2 the card keeps the whole compute copy
        n_pinned, compute_copy = res[f"{off}/host"]
        assert n_pinned > 0
        assert compute_copy == int(stage in (1, 2))
        for k, leaf in params.items():
            d = zero.shard_dim(leaf.shape, W)
            mine = res[f"{off}/bytes/params/{k}"].view(np.float32).ravel()
            whole = res[f"{plain}/bytes/params/{k}"].view(np.float32)
            if stage < 3:
                whole = whole.reshape(leaf.shape)
                if d is not None:
                    c = leaf.shape[d] // W
                    whole = np.take(whole, range(r * c, (r + 1) * c), axis=d)
            np.testing.assert_array_equal(mine, whole.reshape(-1),
                                          err_msg=k)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_lamb_over_ranks_matches_jax(runs, stage):
    want, jp = _jax_run(2, stage, "none", "lamb", 4)
    for name in (f"lamb{stage}", f"lamb{stage}_off"):
        got = runs[2][0][f"{name}/trace"]
        np.testing.assert_array_equal(runs[2][1][f"{name}/trace"], got)
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=RTOL)
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=RTOL)
        for k in jp:
            np.testing.assert_allclose(runs[2][0][f"{name}/params/{k}"],
                                       jp[k], err_msg=k, **PARAM_TOL)
    np.testing.assert_array_equal(runs[2][0][f"lamb{stage}_off/trace"],
                                  runs[2][0][f"lamb{stage}/trace"])


def test_checkpoint_offload_equals_plain_and_loads_at_w1(runs):
    d = runs["dir"]
    for name in ("params.pt", "opt_state.pt", "scalars.json"):
        a = os.path.join(d, "off", "t", "state", name)
        b = os.path.join(d, "plain", "t", "state", name)
        if name.endswith(".pt"):
            ta = torch.load(a, weights_only=True)
            tb = torch.load(b, weights_only=True)
            assert ta.keys() == tb.keys()
            for k in ta:
                assert torch.equal(ta[k], tb[k]), (name, k)
        else:
            assert open(a).read() == open(b).read()
    one = runs[1][0]
    np.testing.assert_array_equal(one["ckpt/step"], [2, 2])
    assert bool(one["ckpt/host"])
    np.testing.assert_allclose(one["ckpt/next"], runs[2][0]["ckpt/next"],
                               rtol=1e-6)
    # the loaded masters are the W = 2 run's after its second step
    saved = torch.load(os.path.join(d, "off", "t", "state", "params.pt"),
                       weights_only=True)
    for k in td.mlp_params():
        np.testing.assert_array_equal(one[f"ckpt/params/{k}"],
                                      saved[k].numpy())
