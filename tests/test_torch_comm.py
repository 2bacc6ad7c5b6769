"""The port's comm layer, topology, mesh and launcher on the CPU.

Four gloo ranks (spawned once through the port's launcher, tests/
_torch_dist.py) run every collective and ``ReduceOp``; each rank's result is
held to numpy and to the JAX package's ``comm`` under ``shard_map`` on four
of the eight virtual CPU devices: f32 results at rtol 1e-6 (sums in another
order), the int8 wire's codes and scales exactly (the same quantizer on
the same inputs), integer-valued exact-codec sums exactly.  The comms
logger's counts and bytes equal the JAX logger's for one trace of the same
calls.  ``shard_leaf_spec`` equals JAX's on a table of shapes; the
launcher's env, hostfile, parser, a clean two-rank run and a failing rank
(its sibling ended, the launcher's code the rank's) are checked directly.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

shard_map = jax.shard_map

import _torch_dist as td
from deepspeed_tpu import comm as jcomm
from deepspeed_tpu import launcher as jlaunch
from deepspeed_tpu import topology as jtopo
from deepspeed_tpu.comm import collectives as jhc
from deepspeed_tpu.ops import quant as jquant
from deepspeed_tpu_torch import launcher as tlaunch
from deepspeed_tpu_torch import mesh as tmesh
from deepspeed_tpu_torch import topology as ttopo
from deepspeed_tpu_torch.comm import collectives as thc

torch.set_num_threads(1)
W = 4
TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs():
    rng = np.random.default_rng(0)
    return {
        "base": rng.standard_normal((W, 5)).astype(np.float32),
        # zeros and negatives for PRODUCT's sign and zero handling
        "prod": np.array([[-2, 3, 0.5, 1], [1, -1, 2, 1], [1, 1, 1, 0],
                          [3, 1, 1, 1]], np.float32),
        "ag": rng.standard_normal((W, 2, 3)).astype(np.float32),
        "rs": rng.standard_normal((W, W * 2, 3)).astype(np.float32),
        "rs1": rng.standard_normal((W, 3, W * 2)).astype(np.float32),
        "qrs": rng.standard_normal((W, W * 2 * 512)).astype(np.float32),
        "row": rng.standard_normal((W, 2048)).astype(np.float32),
        "hin": rng.standard_normal((W, W * 4096 * 2)).astype(np.float32),
        "hint": rng.integers(-8, 8, (W, W * 4096 * 2)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def ranks():
    arr = _inputs()
    return arr, td.run_ranks("comm", W, arrays=arr)


def _jax(fn, x):
    """``fn`` of each device's slice x[d] under shard_map on W devices ->
    the stacked per-device results."""
    ms = jtopo.MeshSpec.build({"data": W}, devices=jax.devices()[:W])
    f = shard_map(lambda v: fn(v[0])[None], mesh=ms.mesh,
                  in_specs=P("data"), out_specs=P("data"))
    return np.asarray(jax.jit(f)(jnp.asarray(x)))


@pytest.mark.parametrize("op", ["SUM", "AVG", "MAX", "MIN", "PRODUCT"])
def test_all_reduce_matches_numpy_and_jax(ranks, op):
    arr, res = ranks
    x = arr["prod" if op == "PRODUCT" else "base"]
    want = {"SUM": x.sum(0), "AVG": x.mean(0), "MAX": x.max(0),
            "MIN": x.min(0), "PRODUCT": x.prod(0)}[op]
    jx = _jax(lambda v: jcomm.all_reduce(v, "data",
                                         getattr(jcomm.ReduceOp, op)), x)
    for r in range(W):
        np.testing.assert_allclose(res[r][f"ar_{op}"], want, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(res[r][f"ar_{op}"], jx[r], rtol=1e-5,
                                   atol=1e-6)
    if op == "PRODUCT":
        assert res[0]["ar_PRODUCT"][3] == 0.0      # one rank's zero wins
        assert res[0]["ar_PRODUCT"][1] < 0        # an odd count of negatives


def test_all_gather_tiled_and_stacked(ranks):
    arr, res = ranks
    cases = {
        "ag_t0": ("base", lambda v: jcomm.all_gather(v, "data")),
        "ag_t1": ("ag", lambda v: jcomm.all_gather(v, "data", axis=1)),
        "ag_u0": ("ag", lambda v: jcomm.all_gather(v, "data",
                                                   tiled=False)),
        "ag_u1": ("ag", lambda v: jcomm.all_gather(v, "data", axis=1,
                                                   tiled=False)),
    }
    for key, (src, fn) in cases.items():
        jx = _jax(fn, arr[src])
        for r in range(W):
            np.testing.assert_array_equal(res[r][key], jx[r], err_msg=key)
    np.testing.assert_array_equal(res[2]["ag_t0"], arr["base"].reshape(-1))


def test_reduce_scatter_broadcast_all_to_all_ppermute(ranks):
    arr, res = ranks
    rs, rs1 = arr["rs"], arr["rs1"]
    cases = {
        "rs_sum": ("rs", lambda v: jcomm.reduce_scatter(v, "data")),
        "rs_avg": ("rs", lambda v: jcomm.reduce_scatter(
            v, "data", op=jcomm.ReduceOp.AVG)),
        "rs_ax1": ("rs1", lambda v: jcomm.reduce_scatter(v, "data", axis=1)),
        "bcast": ("base", lambda v: jcomm.broadcast(v, "data", src=W - 1)),
        "a2a": ("rs", lambda v: jcomm.all_to_all(v, "data", 0, 0)),
        "a2a_10": ("rs1", lambda v: jcomm.all_to_all(v, "data", 1, 0)),
        "ring": ("base", lambda v: jcomm.send_recv_next(v, "data", W)),
    }
    for key, (src, fn) in cases.items():
        jx = _jax(fn, arr[src])
        for r in range(W):
            np.testing.assert_allclose(res[r][key], jx[r], err_msg=key,
                                       **TOL)
    for r in range(W):
        np.testing.assert_allclose(res[r]["rs_avg"],
                                   rs.mean(0)[r * 2:(r + 1) * 2], **TOL)
        np.testing.assert_allclose(res[r]["rs_ax1"],
                                   rs1.sum(0)[:, r * 2:(r + 1) * 2], **TOL)
        np.testing.assert_array_equal(res[r]["bcast"], arr["base"][W - 1])
        np.testing.assert_array_equal(res[r]["ring"],
                                      arr["base"][(r - 1) % W])
        # (0 -> 1), (2 -> 3): ranks no pair sends to get zeros
        want = arr["base"][r - 1] if r in (1, 3) else np.zeros(5)
        np.testing.assert_array_equal(res[r]["partial"], want)
        np.testing.assert_allclose(res[r]["mesh_ar"], arr["base"].sum(0),
                                   **TOL)
        np.testing.assert_array_equal(res[r]["ids"], [r, W, r, r, W])


def test_comms_logger_counts_and_bytes_match_jax(ranks):
    arr, res = ranks
    log = jcomm.comms_logger()
    log.reset()
    ms = jtopo.MeshSpec.build({"data": W}, devices=jax.devices()[:W])

    def f(x, rs):
        x, rs = x[0], rs[0]
        jcomm.all_reduce(x, "data")
        jcomm.all_gather(x, "data")
        jcomm.reduce_scatter(rs, "data")
        jcomm.broadcast(x, "data")
        return jcomm.all_to_all(rs, "data", 0, 0)[None]

    jax.jit(shard_map(f, mesh=ms.mesh, in_specs=(P("data"), P("data")),
                      out_specs=P("data")))(arr["base"], arr["rs"])
    summ = log.summary()
    log.reset()
    for r in range(W):
        ops = list(res[r]["log_ops"])
        assert ops == sorted(summ)
        assert list(res[r]["log_counts"]) == [summ[o]["count"] for o in ops]
        assert list(res[r]["log_bytes"]) == [summ[o]["bytes"] for o in ops]


def test_quantized_reduce_scatter_codes_and_scales_equal_jax(ranks):
    arr, res = ranks
    x = arr["qrs"]
    S = x.shape[1] // W
    for r in range(W):
        # peer j's slice for rank r, through JAX's quantizer
        want = [jquant.quantize(jnp.asarray(x[j, r * S:(r + 1) * S]),
                                num_groups=2) for j in range(W)]
        np.testing.assert_array_equal(
            res[r]["qrs_codes"], np.stack([np.asarray(q) for q, _, _ in want]))
        np.testing.assert_array_equal(
            res[r]["qrs_scales"], np.stack([np.asarray(s) for _, s, _ in want]))
        deq = np.stack([np.asarray(jquant.dequantize(q, s))
                        for q, s, _ in want]).mean(0)
        np.testing.assert_allclose(res[r]["qrs"], deq, **TOL)
    jx = _jax(lambda v: jquant.quantized_reduce_scatter(
        v, "data", groups_per_shard=2), x)
    for r in range(W):
        np.testing.assert_allclose(res[r]["qrs"], jx[r], **TOL)
    # the gather: every peer's codes, through JAX's quantizer op by op
    # (XLA's fused program may take a reciprocal: an ulp off, held at TOL)
    eager = np.stack([np.asarray(jquant.dequantize(*jquant.quantize(
        jnp.asarray(arr["row"][j]), num_groups=4)[:2])) for j in range(W)])
    jg = _jax(lambda v: jquant.quantized_all_gather(v, "data", num_groups=4),
              arr["row"])
    for r in range(W):
        np.testing.assert_array_equal(res[r]["qag"], eager)
        np.testing.assert_allclose(res[r]["qag"], jg[r], **TOL)


def test_hierarchical_schedules_match_jax(ranks):
    arr, res = ranks
    h = jhc.Hierarchy(W, 2)
    for codec in ("blockwise", "group"):
        jx = _jax(lambda v: jhc.hierarchical_all_reduce(
            v, "data", h, codec=codec), arr["hin"])
        jf = _jax(lambda v: jhc.hierarchical_all_reduce(
            v, "data", jhc.Hierarchy(W, 1), codec=codec), arr["hin"])
        for r in range(W):
            np.testing.assert_allclose(res[r][f"hier_{codec}"], jx[r], **TOL)
            np.testing.assert_allclose(res[r][f"flat_{codec}"], jf[r], **TOL)
            # int8 on both hops: within the codec's error of the mean
            np.testing.assert_allclose(res[r][f"hier_{codec}"],
                                       arr["hin"].mean(0), atol=0.05)
    for r in range(W):
        # integer data: the exact codec's sums are exact
        np.testing.assert_array_equal(res[r]["hier_exact"],
                                      arr["hint"].mean(0))
        # hpZ's two hops equal the flat int8 gather bit for bit
        np.testing.assert_array_equal(res[r]["hpz"], res[r]["qag"])
        assert int(res[r]["bucket_elems"]) == jhc.bucket_elems_for(
            0.004, W, "group")
        for leaf in ("a", "b"):
            np.testing.assert_array_equal(res[r][f"bucketed/{leaf}"],
                                          res[r][f"mono/{leaf}"])


SHAPES = [(16, 32), (32,), (4,), (3,), (), (2, 64, 64), (256, 64), (6, 10),
          (5, 7), (8, 8), (1, 12)]


@pytest.mark.parametrize("size", [1, 2, 4, 8])
def test_shard_leaf_spec_matches_jax(size):
    for shape in SHAPES:
        want = tuple(jtopo.shard_leaf_spec(shape, "data", size))
        while want and want[-1] is None:
            want = want[:-1]
        assert ttopo.shard_leaf_spec(shape, "data", size) == want, shape
    assert ttopo.AXES == jtopo.AXES
    assert ttopo.ZERO_AXES == jtopo.ZERO_AXES
    assert ttopo.BATCH_AXES == jtopo.BATCH_AXES


def test_hierarchy_wire_accounting_and_codec_match_jax():
    for world, k in ((8, 2), (4, 4), (4, 1), (6, 3)):
        th, jh = thc.Hierarchy(world, k), jhc.Hierarchy(world, k)
        assert (th.intra_groups, th.inter_groups, th.flat) == \
            (jh.intra_groups, jh.inter_groups, jh.flat)
        for codec in ("blockwise", "group", "exact"):
            assert thc.codec_unit(codec) == jhc.codec_unit(codec)
            assert thc.bucket_elems_for(0.5, world, codec) == \
                jhc.bucket_elems_for(0.5, world, codec)
    with pytest.raises(ValueError, match="does not divide"):
        thc.Hierarchy(4, 3)
    with pytest.raises(ValueError, match="unknown wire codec"):
        thc.codec_unit("fp4")


def test_detect_hierarchy_size(monkeypatch):
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert tmesh.detect_hierarchy_size() == 1
    assert thc.resolve_hierarchy(4, 0).flat


# ----------------------------------------------------------------- launcher
def test_build_env_and_hostfile_match_jax():
    env = tlaunch.build_env("10.0.0.1:29501", 8, 5, base={"X": "1"},
                            local_rank=1, local_world_size=4)
    jenv = jlaunch.build_env("10.0.0.1:29501", 8, 5, base={"X": "1"})
    for k, v in jenv.items():
        assert env[k] == v, k
    assert (env["MASTER_ADDR"], env["MASTER_PORT"], env["LOCAL_RANK"],
            env["LOCAL_WORLD_SIZE"]) == ("10.0.0.1", "29501", "1", "4")
    text = "# cluster\nworker-0 slots=8\n\nworker-1 slots=8 # spare\n"
    assert tlaunch.parse_hostfile(text) == jlaunch.parse_hostfile(text) \
        == ["worker-0", "worker-1"]


def test_parser_passes_script_args_through():
    a = tlaunch.make_parser().parse_args(
        ["--nproc_per_node", "2", "train.py", "--lr", "3", "--deepspeed"])
    assert (a.nproc_per_node, a.script, a.script_args) == \
        (2, "train.py", ["--lr", "3", "--deepspeed"])
    cmd = tlaunch.ssh_command("h1", "h0:29500", 2, 1, 8, "t.py", ["--x"])
    assert cmd[:4] == ["ssh", "-o", "StrictHostKeyChecking=no", "h1"]
    assert "--node_rank 1 --nproc_per_node 8 t.py --x" in cmd[4]
    with pytest.raises(SystemExit):
        tlaunch.main(["--nnodes", "2", "t.py"])


def _launch(tmp_path, world, spec):
    import json

    (tmp_path / "spec.json").write_text(json.dumps(spec))
    np.savez(tmp_path / "inputs.npz")
    env = dict(os.environ, PYTHONPATH=td.ROOT)
    return subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.launcher",
         "--local_hosts", str(world), "--platform", "cpu", td.__file__,
         "hello", str(tmp_path)], cwd=td.ROOT, env=env, timeout=120,
        capture_output=True)


def test_local_hosts_runs_ranks_to_rc0(tmp_path):
    p = _launch(tmp_path, 2, {})
    assert p.returncode == 0, p.stderr.decode()[-3000:]
    for r in range(2):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            np.testing.assert_array_equal(z["sum"], [3.0, 3.0])


def test_failing_rank_ends_its_sibling(tmp_path):
    pid_file = str(tmp_path / "pid")
    p = _launch(tmp_path, 2, {"fail_rank": 1, "pid_file": pid_file})
    assert p.returncode == 3, p.stderr.decode()[-3000:]
    pid = int(open(f"{pid_file}.0").read())
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)
