"""ZeRO++ (qgZ, qwZ, hpZ) and the 1-bit optimizers of the port across four
gloo ranks (one launch, tests/_torch_dist.py), held to the JAX engine in
the same mode on four devices; an MLP with an MSE loss
(tests/test_comm_compress.py's), f32, hidden width 256 so that qgZ's
buckets split the gradient.  Trajectories are held at JAX's own tolerances
in tests/test_comm_compress.py (rtol 0.1 for the int8 wires against exact,
1e-4 / 1e-5 for 1-bit's exact warmup), and tighter where the two ports put
the same codes on the wire (recorded readings in CHANGES.md).  The qwZ row
layout, the nonfinite skip taken on every rank, every refusal of
``resolve_mode`` (the same exception as JAX's, matched by JAX's tests'
patterns) and the world-1 fallback with its warning are checked too."""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
import deepspeed_tpu as dstpu
from deepspeed_tpu import comm_compress as jcc
from deepspeed_tpu.config import Config as JConfig
from deepspeed_tpu.topology import MeshSpec
from deepspeed_tpu_torch import comm_compress as tcc
from deepspeed_tpu_torch import initialize, topology
from deepspeed_tpu_torch.config import Config as TConfig

torch.set_num_threads(1)
W = 4
STEPS = 6


def _conf(zero=None, opt="adamw", opt_params=None, accum=1, comm=None):
    c = {"train_batch_size": 64, "gradient_accumulation_steps": accum,
         "bf16": {"enabled": False},
         "optimizer": {"type": opt, "params": opt_params or {"lr": 5e-2}},
         "zero_optimization": zero or {"stage": 0}}
    if comm:
        c["comm"] = comm
    return c


QGZ, QWZ = "zero_quantized_gradients", "zero_quantized_weights"
CASES = {
    "exact2": (_conf({"stage": 2}), STEPS),
    "qgz": (_conf({"stage": 2, QGZ: True}), STEPS),
    "qgz_bucket": (_conf({"stage": 1, QGZ: True},
                         comm={"codec": "group", "bucket_mb": 0.002}), STEPS),
    "qgz_accum": (_conf({"stage": 0, QGZ: True}, accum=2), STEPS),
    "qgz_hier": (_conf({"stage": 2, QGZ: True},
                       comm={"hierarchy_size": 2}), STEPS),
    "exact3": (_conf({"stage": 3}), STEPS),
    "qwz": (_conf({"stage": 3, QWZ: True}), STEPS),
    "qwz_qgz_accum": (_conf({"stage": 3, QWZ: True, QGZ: True}, accum=2),
                      STEPS),
    "hpz": (_conf({"stage": 3, QWZ: True}, comm={"hierarchy_size": 2}),
            STEPS),
    "onebit_adam": (_conf(opt="OnebitAdam",
                          opt_params={"lr": 1e-2, "freeze_step": 2}), 8),
    "onebit_lamb": (_conf(opt="OnebitLamb",
                          opt_params={"lr": 5e-2, "freeze_step": 2}), 8),
    # one compressed step: the error feedback before signs can diverge
    "onebit_short": (_conf(opt="OnebitAdam",
                           opt_params={"lr": 1e-2, "freeze_step": 2}), 3),
}


@functools.lru_cache(maxsize=None)
def _inputs():
    params = td.mlp_params(seed=1, dh=256)
    params = {k: (v * 3).astype(np.float32) for k, v in params.items()}
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 16)).astype(np.float32)
    y = rng.normal(size=(64, 4)).astype(np.float32)
    return params, x, y


@pytest.fixture(scope="module")
def runs():
    params, x, y = _inputs()
    spec = {"cases": {k: {"conf": c, "steps": n}
                      for k, (c, n) in CASES.items()}}
    return td.run_ranks("zeropp", W, spec=spec,
                        arrays={"pp": params, "x": x, "y": y}, timeout=240)


def _jloss(params, batch):
    h = jnp.tanh(batch["x"] @ params["w1"] + params["b1"])
    pred = h @ params["w2"] + params["b2"]
    return jnp.mean((pred - batch["y"]) ** 2)


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    conf, steps = CASES[name]
    params, x, y = _inputs()
    mesh = MeshSpec.build({"data": W}, devices=jax.devices()[:W])
    eng, _, _, _ = dstpu.initialize(
        loss_fn=_jloss, params=jax.tree.map(jnp.asarray, params),
        config=dict(conf), mesh=mesh)
    batch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    rows = [[float(eng.train_batch(batch)), eng.get_global_grad_norm()]
            for _ in range(steps)]
    return np.asarray(rows), eng


# int8 wires: the same codes on both, so trajectories agree to f32
# reordering.  1-bit: the warmup is exact Adam (1e-5); after it a sign
# taken at a near-zero momentum flips with an ulp of reordering and moves
# the run (read 7.6e-3 on the loss over 6 compressed steps): 5e-2
TIGHT = {"qgz": 1e-5, "qgz_bucket": 1e-5, "qgz_accum": 1e-5,
         "qgz_hier": 1e-5, "qwz": 1e-5, "qwz_qgz_accum": 1e-5, "hpz": 1e-5,
         "onebit_adam": 5e-2, "onebit_lamb": 5e-2, "onebit_short": 1e-5}
MODES = {"qgz": "qgz", "qgz_bucket": "qgz", "qgz_accum": "qgz",
         "qgz_hier": "qgz", "qwz": "qwz", "qwz_qgz_accum": "qwz",
         "hpz": "qwz", "onebit_adam": "onebit", "onebit_lamb": "onebit",
         "onebit_short": "onebit"}
WARMUP = 2


@pytest.mark.parametrize("name", sorted(MODES))
def test_compressed_trajectory_matches_jax_engine(runs, name):
    want, jeng = _jax_run(name)
    assert jeng.grad_comm_mode == MODES[name]
    got = runs[0][f"{name}/trace"]
    for r in range(W):
        assert str(runs[r][f"{name}/mode"]) == MODES[name]
        np.testing.assert_array_equal(runs[r][f"{name}/trace"], got)
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=TIGHT[name])
    if MODES[name] == "onebit":
        np.testing.assert_allclose(got[:WARMUP, :2], want[:WARMUP, :2],
                                   rtol=1e-5)
        # JAX's test: the compressed phase learns
        assert len(got) <= WARMUP + 1 or \
            got[-1, 0] < got[WARMUP, 0] < got[0, 0], "did not learn"
    assert got[-1, 0] < got[0, 0], "did not learn"
    # JAX's own bound against the exact engine (test_comm_compress.py)
    if name.startswith(("qgz", "qwz", "hpz")):
        exact = runs[0]["exact3/trace" if MODES[name] == "qwz"
                        else "exact2/trace"][:, 0]
        np.testing.assert_allclose(got[:, 0], exact, rtol=0.1)


def test_qwz_row_layout_and_nonfinite_skip(runs):
    _, jeng = _jax_run("qwz")
    for r in range(W):
        assert tuple(runs[r]["qwz/row_shape"]) == (jeng._qwz_chunk,)
        # a NaN in rank 0's rows: every rank skips, every row kept
        assert int(runs[r]["qwz/nan_overflow"]) == 1
        assert bool(runs[r]["qwz/nan_kept"])
    jp = jax.device_get(jeng.module_params())
    for k in jp:
        np.testing.assert_allclose(runs[0][f"qwz/params/{k}"], jp[k],
                                   rtol=1e-4, atol=1e-5)


def test_onebit_error_feedback_is_per_rank(runs):
    _, jeng = _jax_run("onebit_short")
    jerr = jax.device_get(jeng.state.opt_state.err)
    for r in range(W):
        for k in ("w1", "w2"):
            got = runs[r][f"onebit_short/err/{k}"]
            scale = np.abs(got).max()
            assert scale > 0
            # f32 reordering moves the odd element across its sign
            # boundary: held at 1e-5 of the buffer's largest error
            np.testing.assert_allclose(got, jerr[k][r], rtol=0,
                                       atol=1e-5 * scale)


def _fake_mesh(sizes):
    return topology.MeshSpec(sizes={a: sizes.get(a, 1)
                                    for a in topology.AXES})


REFUSALS = [
    ({"zero_optimization": {"stage": 1}}, "OnebitAdam", {"data": 4},
     "1-bit"),
    ({"zero_optimization": {"stage": 3, QGZ: True}}, "adamw", {"data": 4},
     "stages 0-2"),
    ({"zero_optimization": {"stage": 2, QWZ: True}}, "adamw", {"data": 4},
     "stage-3"),
    ({"zero_optimization": {"stage": 3, QWZ: True}}, "lamb", {"data": 4},
     "elementwise"),
    ({}, "OnebitAdam", {"data": 4, "model": 2}, "pure data-parallel"),
    ({"zero_optimization": {"stage": 3, QWZ: True}}, "OnebitAdam",
     {"data": 4}, "1-bit"),
    ({"fp16": {"enabled": True}}, "OnebitLamb", {"data": 4}, "bf16/fp32"),
    ({"fp16": {"enabled": True}, "zero_optimization": {"stage": 3,
                                                        QWZ: True}},
     "adamw", {"data": 4}, "bf16/fp32"),
]


@pytest.mark.parametrize("conf,opt,sizes,match", REFUSALS)
def test_refusals_match_jax(conf, opt, sizes, match):
    jms = MeshSpec.build(sizes, devices=jax.devices()[:int(np.prod(
        list(sizes.values())))])
    with pytest.raises(ValueError, match=match) as je:
        jcc.resolve_mode(JConfig.from_dict(dict(conf)), jms, opt, False)
    with pytest.raises(type(je.value), match=match):
        tcc.resolve_mode(TConfig.from_dict(dict(conf)), _fake_mesh(sizes),
                         opt, False)
    with pytest.raises(ValueError, match="has_aux"):
        tcc.resolve_mode(TConfig.from_dict({"zero_optimization": {
            "stage": 1, QGZ: True}}), _fake_mesh({"data": 4}), "adamw",
            True)


@pytest.mark.parametrize("opt,zero", [("OnebitAdam", {"stage": 0}),
                                      ("adamw", {"stage": 3, QWZ: True}),
                                      ("adamw", {"stage": 2, QGZ: True})])
def test_world1_degrades_with_warning(caplog, opt, zero):
    params, x, y = _inputs()
    with caplog.at_level(logging.WARNING):
        eng = initialize(loss_fn=td._mlp_mse, params=params,
                         config=_conf(zero, opt=opt, opt_params={"lr": 1e-2}),
                         device="cpu")[0]
    assert eng.grad_comm_mode is None
    assert any("data-parallel world is 1" in r.getMessage()
               for r in caplog.records)
    batch = {"x": x, "y": y}
    l0 = float(eng.train_batch(batch))
    l1 = float(eng.train_batch(batch))
    assert l1 < l0
