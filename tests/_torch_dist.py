"""Spawned gloo ranks for the port's distributed tests.

:func:`run_ranks` (called from a test file's module fixture) writes a case
spec and its input arrays to a temporary directory and runs this file as
``W`` CPU ranks through the port's own launcher (``python -m
deepspeed_tpu_torch.launcher --local_hosts W --platform cpu``).  Each rank
joins one gloo group, runs every case of its suite in it and writes its
results (numpy arrays) to ``rank<r>.npz``; the fixture hands them back.
Nothing of JAX is imported here, so the ranks never load it; the JAX
oracle runs in the pytest process.  Every wait is bounded: the process
group's (60 s) and the launcher's (``timeout``).
"""

from __future__ import annotations

import datetime
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ----------------------------------------------------------- test side
def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten(flat: dict, prefix: str) -> dict:
    """{'a/b': x, ...} under ``prefix`` -> nested dicts."""
    out: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def run_ranks(suite: str, world: int, spec: dict = None,
              arrays: dict = None, timeout: float = 150.0, workdir=None):
    """Run ``suite`` on ``world`` gloo ranks -> one dict of numpy arrays a
    rank.  Raises with the ranks' output when the launcher exits non-zero
    or the run outlasts ``timeout`` seconds."""
    d = workdir or tempfile.mkdtemp(prefix=f"dstt_{suite}_")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "spec.json"), "w") as f:
        json.dump(spec or {}, f)
    np.savez(os.path.join(d, "inputs.npz"), **_flatten(arrays or {}))
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "deepspeed_tpu_torch.launcher",
           "--local_hosts", str(world), "--platform", "cpu",
           os.path.abspath(__file__), suite, d]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise RuntimeError(f"{suite} on {world} ranks outlasted {timeout} s:"
                           f"\n{out.decode(errors='replace')[-6000:]}")
    if proc.returncode:
        raise RuntimeError(f"{suite} on {world} ranks exited "
                           f"{proc.returncode}:\n"
                           f"{out.decode(errors='replace')[-6000:]}")
    res = []
    for r in range(world):
        with np.load(os.path.join(d, f"rank{r}.npz")) as z:
            res.append({k: z[k] for k in z.files})
    return res


# ----------------------------------------------------------- rank side
def mlp_params(seed=0, din=16, dh=32, dout=4):
    """tests/test_zero_engine.py's MLP, drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    return {"w1": rng.normal(0, 0.1, (din, dh)).astype(np.float32),
            "b1": np.zeros((dh,), np.float32),
            "w2": rng.normal(0, 0.1, (dh, dout)).astype(np.float32),
            "b2": np.zeros((dout,), np.float32)}


def mlp_data(seed=123, n=32, din=16, dout=4):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(0, 1, (n, din)).astype(np.float32),
            "y": rng.integers(0, dout, (n,)).astype(np.int32)}


def _mlp_loss(params, batch):
    import torch

    x, y = batch["x"], batch["y"]
    h = torch.tanh(x @ params["w1"].to(x.dtype) + params["b1"].to(x.dtype))
    logits = (h @ params["w2"].to(x.dtype) + params["b2"].to(x.dtype)).float()
    logp = torch.log_softmax(logits, -1)
    return -torch.mean(torch.gather(logp, 1, y.long()[:, None]))


def _np(t):
    import torch

    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        # a copy: the engine updates its live tensors in place
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()
    return np.asarray(t)


class _Out(dict):
    def put(self, prefix, tree):
        from deepspeed_tpu_torch._tree import tree_leaves_with_path

        for path, leaf in tree_leaves_with_path(tree):
            self[f"{prefix}/{path}" if path else prefix] = _np(leaf)


def _train(out, name, conf, params, batches, steps, loss_fn=_mlp_loss,
           optimizer=None, moments=True):
    """Build an engine, run ``steps`` steps over ``batches`` (cycled), and
    record losses, grad norms, overflow flags, scales and final params."""
    from deepspeed_tpu_torch import initialize

    eng = initialize(loss_fn=loss_fn, params=params, config=conf,
                     optimizer=optimizer, device="cpu")[0]
    rows = []
    for i in range(steps):
        loss = float(eng.train_batch(batches[i % len(batches)]))
        m = eng.metrics
        rows.append([loss, eng.get_global_grad_norm(), m["overflow"],
                     m["loss_scale"]])
    out[f"{name}/trace"] = np.asarray(rows, np.float64)
    out.put(f"{name}/params", eng.module_params())
    if moments and hasattr(eng.state.opt_state, "mu"):
        out.put(f"{name}/mu", eng.state.opt_state.mu)
    return eng


def _suite_comm(out, spec, inputs, W, r):
    import torch

    from deepspeed_tpu_torch import comm, topology
    from deepspeed_tpu_torch.comm import collectives as hc
    from deepspeed_tpu_torch.ops import quant

    t = lambda k: torch.from_numpy(inputs[k][r].copy())   # noqa: E731
    topology.set_current_mesh(topology.default_mesh())
    R = comm.ReduceOp
    x = t("base")
    for op in ("SUM", "AVG", "MAX", "MIN"):
        out[f"ar_{op}"] = _np(comm.all_reduce(x, "data", getattr(R, op)))
    out["ar_PRODUCT"] = _np(comm.all_reduce(t("prod"), "data", R.PRODUCT))
    y = t("ag")
    out["ag_t0"] = _np(comm.all_gather(x, "data"))
    out["ag_t1"] = _np(comm.all_gather(y, "data", axis=1))
    out["ag_u0"] = _np(comm.all_gather(y, "data", tiled=False))
    out["ag_u1"] = _np(comm.all_gather(y, "data", axis=1, tiled=False))
    out["rs_sum"] = _np(comm.reduce_scatter(t("rs"), "data"))
    out["rs_avg"] = _np(comm.reduce_scatter(t("rs"), "data", op=R.AVG))
    out["rs_ax1"] = _np(comm.reduce_scatter(t("rs1"), "data", axis=1))
    out["bcast"] = _np(comm.broadcast(x, "data", src=W - 1))
    out["a2a"] = _np(comm.all_to_all(t("rs"), "data", 0, 0))
    out["a2a_10"] = _np(comm.all_to_all(t("rs1"), "data", 1, 0))
    out["ring"] = _np(comm.send_recv_next(x, "data", W))
    out["partial"] = _np(comm.ppermute(x, "data", [(0, 1), (2, 3)]))
    out["mesh_ar"] = _np(comm.mesh_all_reduce(x))
    out["ids"] = np.asarray([comm.get_rank(), comm.get_world_size(),
                             comm.get_local_rank(), comm.rank_in("data"),
                             comm.get_device_count()])
    # the logger: one record a call, this rank's payload bytes
    log = comm.comms_logger()
    log.reset()
    comm.all_reduce(x, "data")
    comm.all_gather(x, "data")
    comm.reduce_scatter(t("rs"), "data")
    comm.broadcast(x, "data")
    comm.all_to_all(t("rs"), "data", 0, 0)
    summ = log.summary()
    ops = sorted(summ)
    out["log_ops"] = np.asarray(ops)
    out["log_counts"] = np.asarray([summ[o]["count"] for o in ops])
    out["log_bytes"] = np.asarray([summ[o]["bytes"] for o in ops])
    # the int8 wire: capture the codes and scales each all-to-all delivers
    seen = []
    real = comm.all_to_all

    def spy(*a, **k):
        res = real(*a, **k)
        seen.append(_np(res))
        return res

    comm.all_to_all = spy
    try:
        out["qrs"] = _np(quant.quantized_reduce_scatter(
            t("qrs"), "data", groups_per_shard=2))
    finally:
        comm.all_to_all = real
    out["qrs_codes"], out["qrs_scales"] = seen
    out["qag"] = _np(quant.quantized_all_gather(t("row"), "data",
                                                num_groups=4))
    h = hc.resolve_hierarchy(W, 2, ms=topology.current_mesh())
    flat = hc.Hierarchy(W, 1)
    for codec in ("blockwise", "group"):
        out[f"hier_{codec}"] = _np(hc.hierarchical_all_reduce(
            t("hin"), "data", h, codec=codec))
        out[f"flat_{codec}"] = _np(hc.hierarchical_all_reduce(
            t("hin"), "data", flat, codec=codec))
    out["hier_exact"] = _np(hc.hierarchical_all_reduce(
        t("hint"), "data", h, codec="exact"))
    out["hpz"] = _np(hc.hpz_weight_gather(t("row"), "data", h,
                                          num_groups=4))
    tree = {"a": t("hin")[:3000], "b": t("hin")[3000:9001]}
    be = hc.bucket_elems_for(0.004, W, "group")
    out["bucket_elems"] = np.asarray(be)
    for name, b in (("mono", 0), ("bucketed", be)):
        red = hc.hierarchical_all_reduce_tree(tree, "data", flat,
                                              codec="group", bucket_elems=b)
        out.put(name, red)


def _suite_stages(out, spec, inputs, W, r):
    params = mlp_params()
    batch = mlp_data()
    base = {"train_batch_size": 32, "bf16": {"enabled": False},
            "optimizer": {"type": "adam", "params": {"lr": 1e-2}}}
    for stage in range(4):
        _train(out, f"stage{stage}", dict(base, zero_optimization={
            "stage": stage}), params, [batch], 5)
    _train(out, "accum", dict(base, gradient_accumulation_steps=2,
                              zero_optimization={"stage": 2}),
           params, [batch], 5)
    _train(out, "clip", dict(base, gradient_clipping=0.1,
                             zero_optimization={"stage": 3}),
           params, [batch], 5)
    _train(out, "fp16", dict(base, bf16={"enabled": False},
                             fp16={"enabled": True, "initial_scale_power": 20,
                                   "loss_scale_window": 2},
                             zero_optimization={"stage": 2}),
           params, [batch], 8)
    _train(out, "thunk", dict(base, zero_optimization={"stage": 3}),
           lambda: mlp_params(), [batch], 3)


def _llama_params(inputs):
    from deepspeed_tpu_torch.weights import from_jax_params

    flat = {k[len("llama/"):]: v for k, v in inputs.items()
            if k.startswith("llama/")}
    return from_jax_params(unflatten(flat, ""), device="cpu")


def _suite_llama(out, spec, inputs, W, r):
    from deepspeed_tpu_torch.models import llama as tl

    cfg = tl.LlamaConfig.tiny()
    batches = [{"tokens": inputs["tokens"][i]}
               for i in range(inputs["tokens"].shape[0])]
    for stage in range(4):
        conf = {"train_batch_size": 8, "bf16": {"enabled": False},
                "gradient_clipping": 1.0,
                "zero_optimization": {"stage": stage},
                "optimizer": {"type": "adamw",
                              "params": {"lr": 3e-3, "weight_decay": 0.1}}}
        _train(out, f"stage{stage}", conf, _llama_params(inputs), batches, 3,
               loss_fn=tl.loss_fn(cfg))


def _mlp_mse(params, batch):
    import torch

    h = torch.tanh(batch["x"] @ params["w1"] + params["b1"])
    pred = h @ params["w2"] + params["b2"]
    return torch.mean((pred - batch["y"]) ** 2)


def _suite_zeropp(out, spec, inputs, W, r):
    import torch

    params = {k[len("pp/"):]: v for k, v in inputs.items()
              if k.startswith("pp/")}
    batch = {"x": inputs["x"], "y": inputs["y"]}
    for name, case in spec["cases"].items():
        eng = _train(out, name, case["conf"], params, [batch],
                     case["steps"], loss_fn=_mlp_mse, moments=False)
        out[f"{name}/mode"] = np.asarray(eng.grad_comm_mode or "none")
        if name == "qwz":
            out[f"{name}/row_shape"] = np.asarray(eng.state.params.shape)
            bad = {"x": batch["x"].copy(), "y": batch["y"]}
            bad["x"][0, 0] = np.nan                 # rank 0's rows only
            before = eng.state.params.clone()
            eng.train_batch(bad)
            out[f"{name}/nan_overflow"] = np.asarray(
                eng.metrics["overflow"])
            out[f"{name}/nan_kept"] = np.asarray(
                bool(torch.equal(before, eng.state.params)))
        if name.startswith("onebit"):
            out.put(f"{name}/err", eng.state.opt_state.err)


def _suite_ckpt(out, spec, inputs, W, r):
    from deepspeed_tpu_torch import checkpoint, initialize, zero

    params = mlp_params(dh=64)
    batches = [mlp_data(seed=s) for s in (1, 2, 3)]
    conf = {"train_batch_size": 32, "bf16": {"enabled": False},
            "zero_optimization": {"stage": spec["stage"]},
            "optimizer": {"type": "adam", "params": {"lr": 1e-2}}}
    eng = initialize(loss_fn=_mlp_loss, params=params, config=conf,
                     device="cpu")[0]
    if spec["save"]:
        for b in batches[:2]:
            eng.train_batch(b)
        eng.save_checkpoint(spec["dir"], tag="t")
        if r == 0:
            checkpoint.zero_to_fp32(spec["dir"], spec["dir"] + "/fp32.npz")
    else:
        eng.load_checkpoint(spec["dir"])
    _, pdims, odims = eng.state_layout()
    out.put("params", eng.module_params())
    for f in ("mu", "nu"):
        tree = getattr(eng.state.opt_state, f)
        out.put(f, zero.unshard_params(tree, odims))
    out["step"] = np.asarray([eng.state.step, eng.global_steps])
    out["next_loss"] = np.asarray(float(eng.train_batch(batches[2])))


def _suite_hello(out, spec, inputs, W, r):
    import torch

    from deepspeed_tpu_torch import comm, topology

    topology.set_current_mesh(topology.default_mesh())
    out["sum"] = _np(comm.all_reduce(torch.ones(2) * (r + 1), "data"))
    pid_file = spec.get("pid_file")
    if spec.get("fail_rank") == r:
        # fail once every sibling is known to be waiting
        for _ in range(300):
            if all(os.path.exists(f"{pid_file}.{q}") for q in range(W)
                   if q != r):
                break
            time.sleep(0.1)
        sys.exit(3)
    if pid_file:
        with open(f"{pid_file}.{r}", "w") as f:
            f.write(str(os.getpid()))
        time.sleep(60)              # deaf to the failure: the launcher ends it


SUITES = {"comm": _suite_comm, "stages": _suite_stages,
          "llama": _suite_llama, "zeropp": _suite_zeropp,
          "ckpt": _suite_ckpt, "hello": _suite_hello}


def main(argv):
    import torch

    from deepspeed_tpu_torch import comm

    torch.set_num_threads(1)
    suite, d = argv[1], argv[2]
    with open(os.path.join(d, "spec.json")) as f:
        spec = json.load(f)
    with np.load(os.path.join(d, "inputs.npz")) as z:
        inputs = {k: z[k] for k in z.files}
    comm.init_distributed(dist_backend="gloo",
                          timeout=datetime.timedelta(seconds=60))
    W, r = comm.get_world_size(), comm.get_rank()
    out = _Out()
    SUITES[suite](out, spec, inputs, W, r)
    np.savez(os.path.join(d, f"rank{r}.npz"), **out)
    comm.barrier()
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
