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


def numpy_params(init_params, cfg, seed=0, std=0.05):
    """A param tree of ``init_params(key, cfg)``'s shapes drawn from a numpy
    seed (norm scales about 1), without running the JAX initializer."""
    import jax

    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: init_params(k, cfg),
                            jax.random.PRNGKey(0))

    def draw(path, s):
        x = rng.normal(0, std, s.shape)
        if "norm" in jax.tree_util.keystr(path) and \
                "bias" not in jax.tree_util.keystr(path):
            x = x + 1.0
        return x.astype(s.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def bert_unequal_batch(seed=11, B=4, T=16):
    """A tiny-BERT MLM batch whose labels split 10 / 15 over the halves of
    its rows (data ranks 0 / 1 at data = 2); row 3 pads its last two
    positions."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (B, T)).astype(np.int32)
    labels = np.full((B, T), -100, np.int32)
    mask = np.ones((B, T), np.int32)
    mask[3, T - 2:] = 0
    for row, n in ((0, 6), (1, 4), (2, 8), (3, 7)):
        pos = rng.choice(int(mask[row].sum()), n, replace=False)
        labels[row, pos] = toks[row, pos]
    return {"tokens": toks, "attention_mask": mask,
            "token_type_ids": rng.integers(0, 2, (B, T)).astype(np.int32),
            "mlm_labels": labels}


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
           optimizer=None, moments=True, **kw):
    """Build an engine, run ``steps`` steps over ``batches`` (cycled), and
    record losses, grad norms, overflow flags, scales and final params."""
    from deepspeed_tpu_torch import initialize

    eng = initialize(loss_fn=loss_fn, params=params, config=conf,
                     optimizer=optimizer, device="cpu", **kw)[0]
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
    pdims, odims = eng.state_layout()[1:3]
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


# ----------------------------------------------- model-parallel mesh axes
def _tree_params(inputs, prefix):
    from deepspeed_tpu_torch.weights import from_jax_params

    flat = {k[len(prefix) + 1:]: v for k, v in inputs.items()
            if k.startswith(prefix + "/")}
    return from_jax_params(unflatten(flat, ""), device="cpu")


def _use_mesh(sizes):
    from deepspeed_tpu_torch import topology

    ms = topology.MeshSpec.build(sizes)
    topology.set_current_mesh(ms)
    return ms


def _suite_tp(out, spec, inputs, W, r):
    """Tensor-parallel training of tiny Llama (W = 2: model 2; W = 4:
    data 2 x model 2), a stage-0 checkpoint of it, and Megatron's four
    mappings' values and grads."""
    import torch

    from deepspeed_tpu_torch import comm, initialize
    from deepspeed_tpu_torch.models import llama as tl

    sizes = {"model": 2} if W == 2 else {"data": 2, "model": 2}
    cfg = tl.LlamaConfig.tiny()
    batches = [{"tokens": inputs["tokens"][i]}
               for i in range(inputs["tokens"].shape[0])]
    for stage in spec["stages"][str(W)]:
        conf = {"train_batch_size": 8, "bf16": {"enabled": False},
                "gradient_clipping": 1.0, "mesh": sizes,
                "zero_optimization": {"stage": stage},
                "optimizer": {"type": "adamw",
                              "params": {"lr": 3e-3, "weight_decay": 0.1}}}
        eng = _train(out, f"stage{stage}", conf, _tree_params(inputs, "llama"),
                     batches, 3, loss_fn=tl.loss_fn(cfg),
                     param_specs=tl.param_specs(cfg))
        if stage == spec["ckpt_stage"]:
            d = os.path.join(spec["dir"], f"w{W}")
            eng.save_checkpoint(d, tag="t")
            # read back into a TP engine of another stage
            back = initialize(loss_fn=tl.loss_fn(cfg),
                              params=_tree_params(inputs, "llama"),
                              config=dict(conf, zero_optimization={
                                  "stage": 3 - stage}),
                              param_specs=tl.param_specs(cfg),
                              device="cpu")[0]
            back.load_checkpoint(d)
            out.put("ckpt/params", back.module_params())
            out.put("ckpt/saved", eng.module_params())
            out["ckpt/next"] = np.asarray([
                float(e.train_batch(batches[0])) for e in (eng, back)])
    # the mappings over model, rank m of the axis
    m, tp = comm.rank_in("model"), 2
    x = torch.arange(6.0).reshape(2, 3).requires_grad_(True)
    y = comm.copy_to(x, "model") * (m + 1)
    y.sum().backward()
    out["copy_to/y"], out["copy_to/g"] = _np(y), _np(x.grad)
    x = torch.arange(6.0).reshape(2, 3).requires_grad_(True)
    y = comm.reduce_from(x * (m + 1), "model")
    y.sum().backward()
    out["reduce_from/y"], out["reduce_from/g"] = _np(y), _np(x.grad)
    x = (torch.arange(4.0).reshape(2, 2) + 10 * m).requires_grad_(True)
    y = comm.gather_from(x, "model", -1)
    (y * torch.arange(2.0 * 2 * tp).reshape(2, 2 * tp)).sum().backward()
    out["gather_from/y"], out["gather_from/g"] = _np(y), _np(x.grad)
    x = torch.arange(8.0).reshape(2, 4).requires_grad_(True)
    y = comm.scatter_to(x, "model", -1)
    (y * (m + 1)).sum().backward()
    out["scatter_to/y"], out["scatter_to/g"] = _np(y), _np(x.grad)


def _serve(eng, prompts):
    for rid, (p, n) in prompts.items():
        eng.submit(rid, [int(t) for t in p], max_new_tokens=int(n))
    res = eng.run()
    return {rid: [int(t) for t in res[rid]] for rid in prompts}


def _put_tokens(out, name, toks):
    for rid, t in toks.items():
        out[f"{name}/{rid}"] = np.asarray(t, np.int64)


def _suite_serve_tp(out, spec, inputs, W, r):
    """Tensor-parallel serving of tiny Llama over model 2: the engine (also
    split-fuse with decode chunks, int8 weights and the int8 wire),
    init_inference and init_serving, and the refusal of KV heads that do
    not split."""
    import torch

    from deepspeed_tpu_torch.inference import init_inference, init_serving
    from deepspeed_tpu_torch.inference.serving import llama_serving_engine
    from deepspeed_tpu_torch.models import llama as tl

    ms = _use_mesh({"model": 2})
    cfg = tl.LlamaConfig.tiny(dim=64, n_layers=2, n_heads=4, n_kv_heads=2)
    params = _tree_params(inputs, "llama")
    prompts = spec["prompts"]
    kw = dict(spec["kw"], device="cpu", cache_dtype=torch.float32)
    runs = {"tp": {}, "split": dict(prefill_chunk=4, decode_chunk=2),
            "int8": dict(weight_dtype="int8", quant_group_size=16),
            "wire": dict(comm={"quantized_serving": True,
                               "serving_rtol": 0.05})}
    for name, extra in runs.items():
        eng = llama_serving_engine(params, cfg, mesh=ms, **dict(kw, **extra))
        _put_tokens(out, name, _serve(eng, prompts))
        out[f"{name}/cache_heads"] = np.asarray(eng.cache.k.shape[1])
        assert eng.check_leaks() == []
        if name == "int8":
            qt = eng.params["blocks"]["wq"]
            out["int8/wq_q"] = _np(qt.q)
            out["int8/wq_scale"] = _np(qt.scale)
        if name == "wire":
            st = eng.comm_placement
            out["wire/stats"] = np.asarray(
                [st["leaves_quantized"], st["leaves_exact"]])
            out.put("wire/params", eng.params)
    eng = init_serving(params, cfg, config={"mesh": {"model": 2}}, **kw)
    _put_tokens(out, "init_serving", _serve(eng, prompts))
    # int8-resident KV (B7 / B9's fused write) at a rank's KV heads: two
    # waves on one prefix, the idle step between demoting the warm pages
    eng = llama_serving_engine(params, cfg, mesh=ms, **dict(
        kw, **spec["kvq"]))
    for i, wave in enumerate(spec["waves"]):
        if i:
            eng.step()
            held = next(iter(eng._kv_pool.entries.values()))
            out["kvq/tier_page_shape"] = np.asarray(held.data[0].shape)
        for rid, p in wave.items():
            eng.submit(rid, p, max_new_tokens=8)
        for rid, t in eng.run().items():
            out[f"kvq/tok/{rid}"] = np.asarray(t, np.int64)
        assert eng.check_leaks() == []
    for name in ("k", "v", "k_scale", "v_scale"):
        out[f"kvq/{name}"] = _np(getattr(eng.cache, name))
    out["kvq/counts"] = np.asarray([
        eng.allocator.demoted, eng.allocator.promoted,
        eng.kv_tier_quant_resident_promotes, eng.prefix_cache_hits])
    tokens = torch.from_numpy(inputs["fwd_tokens"])
    for dt in ("float32", "int8"):
        import functools

        ie = init_inference(apply_fn=functools.partial(tl.forward, cfg=cfg),
                            params=params, mesh=ms,
                            param_specs=tl.param_specs(cfg), dtype=dt,
                            device="cpu")
        out[f"ie_{dt}/logits"] = _np(ie(tokens))
    bad = tl.LlamaConfig.tiny(dim=48, n_layers=1, n_heads=3, n_kv_heads=3)
    from deepspeed_tpu_torch.weights import init_params

    bp = init_params(bad, torch.Generator().manual_seed(1), device="cpu",
                     dtype=torch.float32)
    try:
        llama_serving_engine(bp, bad, mesh=ms, **kw)
        out["refused"] = np.asarray("")
    except ValueError as e:
        out["refused"] = np.asarray(str(e))


def _seq_qkv(inputs, r, sp):
    import torch

    def part(k):
        a = inputs[k]
        n = a.shape[1] // sp
        return torch.from_numpy(a[:, r * n:(r + 1) * n].copy())

    return part


def _suite_sp(out, spec, inputs, W, r):
    """Sequence parallelism over seq = W: ring and Ulysses attention on
    this rank's positions (values and grads of a global loss), with
    segment ids and GQA broadcast; the collectives' transposes; tiny
    Llama trained with attn_impl ring and ulysses."""
    import torch

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import llama as tl
    from deepspeed_tpu_torch.ops.attention import _reference
    from deepspeed_tpu_torch.parallel.ring_attention import (
        ring_attention_sharded)
    from deepspeed_tpu_torch.parallel.sequence_parallel import (
        ulysses_attention_sharded)

    _use_mesh({"seq": W})
    part = _seq_qkv(inputs, r, W)

    def ref_attn(q, k, v, causal, segment_ids=None):
        return _reference(q, k, v, causal=causal, segment_ids=segment_ids)

    for impl in ("ring", "ulysses"):
        for case in ("plain", "seg", "gqa"):
            pre = "gqa_" if case == "gqa" else ""
            q, k, v = (part(pre + n).requires_grad_(True)
                       for n in ("q", "k", "v"))
            seg = part("seg") if case == "seg" else None
            if impl == "ring":
                o = ring_attention_sharded(q, k, v, segment_ids=seg)
            else:
                o = ulysses_attention_sharded(q, k, v, attn_fn=ref_attn,
                                              segment_ids=seg)
            (o ** 2).sum().backward()
            out[f"{impl}/{case}/o"] = _np(o)
            for n, t in (("q", q), ("k", k), ("v", v)):
                out[f"{impl}/{case}/d{n}"] = _np(t.grad)
    # the collectives' transposes on this rank's x
    x = torch.arange(8.0).reshape(4, 2) + 100 * r
    w = torch.arange(8.0 * W).reshape(4 * W, 2) + 1
    for name in ("psum", "all_gather", "reduce_scatter", "all_to_all",
                 "ppermute"):
        t = x.clone().requires_grad_(True)
        if name == "psum":
            y = comm.all_reduce(t, "seq")
            loss = (y * w[:4]).sum()
        elif name == "all_gather":
            y = comm.all_gather(t, "seq")
            loss = (y * w).sum()
        elif name == "reduce_scatter":
            y = comm.reduce_scatter(t, "seq")
            loss = (y * w[:y.shape[0]] * (r + 1)).sum()
        elif name == "all_to_all":
            y = comm.all_to_all(t, "seq", 0, 1)
            loss = (y * torch.arange(float(y.numel())).reshape(y.shape)
                    ).sum()
        else:
            y = comm.ppermute(t, "seq", [(i, (i + 1) % W)
                                         for i in range(W)])
            loss = (y * (r + 1)).sum()
        loss.backward()
        out[f"coll/{name}/y"], out[f"coll/{name}/g"] = _np(y), _np(t.grad)
    batches = [{"tokens": inputs["tokens"][i]}
               for i in range(inputs["tokens"].shape[0])]
    for impl in ("ring", "ulysses"):
        cfg = tl.LlamaConfig.tiny(attn_impl=impl)
        conf = {"train_batch_size": 4, "bf16": {"enabled": False},
                "gradient_clipping": 1.0, "mesh": {"seq": W, "data": 1},
                "optimizer": {"type": "adamw",
                              "params": {"lr": 3e-3, "weight_decay": 0.1}}}
        _train(out, f"train_{impl}", conf, _tree_params(inputs, "llama"),
               batches, 3, loss_fn=tl.loss_fn(cfg))


def _pp_block(x, lp):
    import torch

    return torch.tanh(x @ lp["w"]) + x


def _suite_pp(out, spec, inputs, W, r):
    """Pipeline parallelism (W = 2: pipe 2; W = 4: pipe 2 x data 2 for
    training, pipe 4 for the scan): pipelined_scan's values and grads
    under three remat settings, the pipelined Llama forward, and Llama
    trained with n_micro 4."""
    import torch

    from deepspeed_tpu_torch.models import llama as tl
    from deepspeed_tpu_torch.parallel.pipeline import pipelined_scan

    S = W
    ms = _use_mesh({"pipe": S})
    stage = ms.rank_in("pipe")
    w = torch.from_numpy(inputs["pp_w"])
    L = w.shape[0]
    x = torch.from_numpy(inputs["pp_x"])
    for remat in ("none", "full", "save_dots"):
        lw = w[stage * L // S:(stage + 1) * L // S].clone() \
            .requires_grad_(True)
        xr = x.clone().requires_grad_(True)
        y = pipelined_scan(_pp_block, {"w": lw}, xr, 4, ms, remat=remat)
        (y ** 2).sum().backward()
        out[f"scan/{remat}/y"] = _np(y)
        out[f"scan/{remat}/dw"] = _np(lw.grad)
        out[f"scan/{remat}/dx"] = _np(xr.grad)
    cfg = tl.LlamaConfig.tiny(attn_impl="reference", n_layers=4)
    full = _tree_params(inputs, "llama")
    from deepspeed_tpu_torch import zero

    specs = tl.param_specs(cfg, pipeline=True)
    local = {k: v for k, v in full.items()}
    local["blocks"] = {k: zero.local_shard(v, specs["blocks"][k], ms)
                       for k, v in full["blocks"].items()}
    toks = torch.from_numpy(inputs["fwd_tokens"])
    with torch.no_grad():
        out["llama/logits"] = _np(tl.forward(local, toks, cfg, n_micro=4))
    sizes = {"pipe": 2} if W == 2 else {"pipe": 2, "data": 2}
    _use_mesh(sizes)
    batches = [{"tokens": inputs["tokens"][i]}
               for i in range(inputs["tokens"].shape[0])]
    conf = {"train_batch_size": 16, "gradient_accumulation_steps": 4,
            "mesh": sizes, "pipeline": {"stages": 2},
            "zero_optimization": {"stage": 0},
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "bf16": {"enabled": False}}
    _train(out, "train", conf, full, batches, 3,
           loss_fn=tl.loss_fn(cfg, n_micro=4),
           param_specs=tl.param_specs(cfg, pipeline=True))


def _suite_ep(out, spec, inputs, W, r):
    """Expert parallelism (W = 2: expert 2; W = 4: data 2 x expert 2, and
    expert 2 x model 2 for serving): the MoE layer on this rank's rows,
    Mixtral trained over the mesh, and Mixtral served over it."""
    import torch

    from deepspeed_tpu_torch import zero
    from deepspeed_tpu_torch.config import MoEConfig
    from deepspeed_tpu_torch.inference.serving import mixtral_serving_engine
    from deepspeed_tpu_torch.models import mixtral as tm
    from deepspeed_tpu_torch.parallel.moe import (MoELayer,
                                                  expert_param_specs)

    sizes = {"expert": 2} if W == 2 else {"data": 2, "expert": 2}
    ms = _use_mesh(sizes)
    ep = {k: torch.from_numpy(inputs[f"moe/{k}"]) for k in ("w1", "w2")}
    especs = expert_param_specs({"w1": None, "w2": None})
    ep = {k: zero.local_shard(v, especs[k], ms).clone().requires_grad_(True)
          for k, v in ep.items()}
    x = torch.from_numpy(inputs["moe/x"])
    n = x.shape[0] // ms.dp_world
    xl = x[ms.batch_index() * n:(ms.batch_index() + 1) * n].clone() \
        .requires_grad_(True)
    gate = torch.from_numpy(inputs["moe/gate"]).requires_grad_(True)

    def expert(p, h):
        return torch.tanh(h @ p["w1"]) @ p["w2"]

    for k in (1, 2):
        layer = MoELayer(cfg=MoEConfig(enabled=True, num_experts=4, top_k=k,
                                       capacity_factor=1.0, min_capacity=1),
                         expert_fn=expert, mesh=ms)
        y, aux = layer(gate, ep, xl)
        for t in (xl, gate, *ep.values()):
            t.grad = None
        # this rank's share of the global mean, as the engine takes it
        ((y ** 2).mean() / ms.dp_world + aux["moe_aux_loss"]
         / ms.dp_world).backward()
        out[f"moe{k}/y"] = _np(y)
        out[f"moe{k}/aux"] = _np(aux["moe_aux_loss"])
        out[f"moe{k}/load"] = _np(aux["moe_expert_load"])
        out[f"moe{k}/dx"] = _np(xl.grad)
        out[f"moe{k}/dgate"] = _np(gate.grad)
        out[f"moe{k}/dw1"] = _np(ep["w1"].grad)
    cfg = tm.MixtralConfig.tiny(attn_impl="reference")
    batches = [{"tokens": inputs["tokens"][i]}
               for i in range(inputs["tokens"].shape[0])]
    conf = {"train_batch_size": 8, "bf16": {"enabled": False},
            "mesh": sizes, "zero_optimization": {"stage": 0},
            "optimizer": {"type": "adamw", "params": {"lr": 3e-3}}}
    _train(out, "train", conf, _tree_params(inputs, "mixtral"), batches, 3,
           loss_fn=tm.loss_fn(cfg), has_aux=True,
           param_specs=tm.param_specs(cfg))
    serve = {"expert": 2} if W == 2 else {"expert": 2, "model": 2}
    sms = _use_mesh(serve)
    eng = mixtral_serving_engine(
        _tree_params(inputs, "mixtral"), cfg, mesh=sms, device="cpu",
        cache_dtype=torch.float32, **spec["kw"])
    _put_tokens(out, "serve", _serve(eng, spec["prompts"]))
    out["serve/w1_shape"] = np.asarray(eng.params["blocks"]["w1"].shape)


SUITES.update({"tp": _suite_tp, "serve_tp": _suite_serve_tp,
               "sp": _suite_sp, "pp": _suite_pp, "ep": _suite_ep})


# ------------------------------------------------- the offload engines
OFFLOAD_BLOCKS = {
    "opt": {"offload_optimizer": {"device": "cpu"}},
    "param": {"offload_param": {"device": "cpu"}},
    "both": {"offload_optimizer": {"device": "cpu"},
             "offload_param": {"device": "cpu"}}}


def _state_bytes(eng) -> dict:
    """Every tensor of the engine's state as raw bytes (uint8), keyed by
    its place: the shards a rank holds, host or card."""
    import torch

    from deepspeed_tpu_torch._tree import tree_leaves_with_path

    out = {}
    for name, tree in (("params", eng.state.params),
                       ("opt", eng.state.opt_state[1:])):
        for path, t in tree_leaves_with_path(tree):
            if isinstance(t, torch.Tensor):
                out[f"{name}/{path}"] = t.detach().cpu().contiguous() \
                    .view(torch.uint8).numpy().copy()
    return out


def _suite_offload(out, spec, inputs, W, r):
    """ZeRO-Offload (unscheduled cpu blocks) at stages 1-3 beside the same
    stages without the block (the MLP, 5 steps), the shards each keeps,
    LAMB at stages 1-3, a dry step's digest, and checkpoints: saved with
    and without the block (W = 2), or loaded from W = 2's (W = 1)."""
    from deepspeed_tpu_torch import initialize

    params, batch = mlp_params(), mlp_data()
    base = {"train_batch_size": 32, "bf16": {"enabled": False},
            "gradient_clipping": 1.0,
            "optimizer": {"type": "adam", "params": {"lr": 1e-2}}}
    for stage in (1, 2, 3):
        for name, blk in [("plain", {})] + list(OFFLOAD_BLOCKS.items()):
            eng = _train(out, f"s{stage}_{name}", dict(
                base, zero_optimization=dict(stage=stage, **blk)),
                params, [batch], 5)
            for k, v in _state_bytes(eng).items():
                out[f"s{stage}_{name}/bytes/{k}"] = v
            if name != "plain":
                out[f"s{stage}_{name}/host"] = np.asarray(
                    [len(eng._pinned), int(eng._cparams is not None)])
        lamb = dict(base, optimizer={"type": "lamb",
                                     "params": {"lr": 1e-2,
                                                "weight_decay": 0.01}})
        _train(out, f"lamb{stage}", dict(lamb, zero_optimization={
            "stage": stage}), params, [batch], 4)
        _train(out, f"lamb{stage}_off", dict(lamb, zero_optimization=dict(
            stage=stage, **OFFLOAD_BLOCKS["opt"])), params, [batch], 4)
    ck = spec.get("dir")
    if ck is None:
        return
    conf = dict(base, zero_optimization=dict(stage=2,
                                             **OFFLOAD_BLOCKS["both"]))
    if W == spec["save_w"]:
        for name, blk in (("off", OFFLOAD_BLOCKS["both"]), ("plain", {})):
            eng = initialize(loss_fn=_mlp_loss, params=params, config=dict(
                base, zero_optimization=dict(stage=2, **blk)),
                device="cpu")[0]
            for _ in range(2):
                eng.train_batch(batch)
            eng.save_checkpoint(os.path.join(ck, name), tag="t")
        out["ckpt/next"] = np.asarray(float(eng.train_batch(batch)))
    else:
        eng = initialize(loss_fn=_mlp_loss, params=params,
                         config=dict(conf, zero_optimization=dict(
                             stage=3, **OFFLOAD_BLOCKS["opt"])),
                         device="cpu")[0]
        eng.load_checkpoint(os.path.join(ck, "off"))
        out.put("ckpt/params", eng.module_params())
        out["ckpt/step"] = np.asarray([eng.state.step, eng.global_steps])
        out["ckpt/next"] = np.asarray(float(eng.train_batch(batch)))
        out["ckpt/host"] = np.asarray(all(
            t.device.type == "cpu"
            for t in list(eng.state.opt_state.mu.values())))


def _digest_arrays(out, name, d):
    kinds = sorted(d["per_kind"])
    out[f"{name}/kinds"] = np.asarray(kinds)
    out[f"{name}/counts"] = np.asarray([d["per_kind"][k]["count"]
                                        for k in kinds])
    out[f"{name}/bytes"] = np.asarray([d["per_kind"][k]["bytes"]
                                       for k in kinds])
    out[f"{name}/totals"] = np.asarray([d["total_collectives"],
                                        d["total_bytes"], d["est_wire_ms"],
                                        d["link_gbps_model"]])


def _suite_digest(out, spec, inputs, W, r):
    """comms_digest of the MLP at stages 0-3 (with and without an offload
    block), of qgZ and of the Infinity engine, and the trajectories of
    engines that took a digest between their steps against engines that
    did not."""
    from deepspeed_tpu_torch import initialize

    params, batch = mlp_params(), mlp_data()
    base = {"train_batch_size": 32, "bf16": {"enabled": False},
            "optimizer": {"type": "adam", "params": {"lr": 1e-2}}}
    confs = {f"stage{s}": dict(base, zero_optimization={"stage": s})
             for s in range(4)}
    confs["stage2_off"] = dict(base, zero_optimization=dict(
        stage=2, **OFFLOAD_BLOCKS["both"]))
    confs["fp16"] = dict(base, fp16={"enabled": True,
                                     "initial_scale_power": 20,
                                     "loss_scale_window": 2},
                         zero_optimization={"stage": 1})
    confs["qgz"] = dict(base, zero_optimization={
        "stage": 2, "zero_quantized_gradients": True})
    for name, conf in confs.items():
        runs = []
        for probe in (False, True):
            eng = initialize(loss_fn=_mlp_loss, params=params,
                             config=dict(conf), device="cpu")[0]
            losses = []
            for i in range(3):
                if probe:
                    d = eng.comms_digest(batch)
                losses.append(float(eng.train_batch(batch)))
            runs.append((losses, eng))
            if probe:
                _digest_arrays(out, name, d)
        (l0, e0), (l1, e1) = runs
        out[f"{name}/losses"] = np.asarray([l0, l1])
        out[f"{name}/same_state"] = np.asarray(all(
            (a == b).all() for a, b in zip(
                _state_bytes(e0).values(), _state_bytes(e1).values())))
        out[f"{name}/leaves"] = np.asarray(len(e0._shapes))
        out[f"{name}/n"] = np.asarray(sum(int(np.prod(s))
                                          for s in e0._shapes))
    from deepspeed_tpu_torch.models import llama as tl

    cfg = tl.LlamaConfig.tiny(dim=64, n_layers=2, n_heads=4, n_kv_heads=2)
    conf = {"train_batch_size": 8, "bf16": {"enabled": True},
            "zero_optimization": {"stage": 3, "offload_optimizer": {
                "device": "cpu", "scheduled": True}},
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}
    toks = {"tokens": inputs["tokens"]}
    eng = initialize(loss_fn=tl.loss_fn(cfg), params=_tree_params(
        inputs, "llama"), config=conf, device="cpu")[0]
    _digest_arrays(out, "infinity", eng.comms_digest(toks))
    out["infinity/sizes"] = np.asarray(eng._chunks)
    out["infinity/loss"] = np.asarray(float(eng.train_batch(toks)))


def _pstream_conf(tier=None, **over):
    conf = {"train_batch_size": 8,
            "zero_optimization": {
                "stage": 3,
                "offload_param": tier or {"device": "cpu",
                                          "scheduled": True}},
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "bf16": {"enabled": True}}
    conf.update(over)
    return conf


def _suite_pstream(out, spec, inputs, W, r):
    """JAX's two-process param-stream scenario (tiny Llama, dim 64, 2
    layers, 4/2 heads, 8 rows): 3 steps' losses, the step-3 grad norm and
    the gathered masters; resuming from its universal checkpoint; the NVMe
    tier beside the RAM tier; the model-parallel engine over model = W
    (param_specs); and a checkpoint saved by another world size loaded
    here (``spec["load"]``)."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import llama as tl

    cfg = tl.LlamaConfig.tiny(dim=64, n_layers=2, n_heads=4, n_kv_heads=2)
    batch = {"tokens": inputs["tokens"]}

    def build(conf, **kw):
        return initialize(params=tl.layered_model(
            cfg, _tree_params(inputs, "llama")), config=conf,
            device="cpu", **kw)[0]

    def run(name, eng, steps=3):
        losses = [float(eng.train_batch(batch)) for _ in range(steps)]
        out[f"{name}/losses"] = np.asarray(losses)
        out[f"{name}/norm"] = np.asarray(eng.get_global_grad_norm())
        out.put(f"{name}/master", eng.master_params())
        return eng

    if spec.get("load"):
        eng = build(_pstream_conf())
        eng.load_checkpoint(spec["load"])
        out["resume/loss"] = np.asarray(float(eng.train_batch(batch)))
        return
    eng = run("ram", build(_pstream_conf()))
    out["ram/overlap"] = np.asarray(eng.overlap_step)
    out["ram/chunks"] = np.asarray(eng._schunks)
    ck = os.path.join(spec["dir"], f"w{W}")
    eng.save_checkpoint(ck)
    e2 = build(_pstream_conf())
    e2.load_checkpoint(ck)
    out["resume/pair"] = np.asarray([float(eng.train_batch(batch)),
                                     float(e2.train_batch(batch))])
    nv = {"device": "nvme", "nvme_path": os.path.join(spec["dir"], "nv")}
    run("nvme", build(_pstream_conf(nv)))
    out["nvme/dirs"] = np.asarray(sorted(os.listdir(nv["nvme_path"])))
    if W == 2:
        _use_mesh({"model": 2})
        run("tp", build(_pstream_conf(mesh={"model": 2}),
                        param_specs=tl.param_specs(cfg)))


def _suite_infinity(out, spec, inputs, W, r):
    """JAX's two-process Infinity scenario (tiny Llama, 8 rows, 2 steps)
    on the RAM tier (device and host updates) and on NVMe, the gathered
    masters, a checkpoint round trip, and the model-parallel engine over
    model = W (param_specs)."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import llama as tl

    cfg = tl.LlamaConfig.tiny(dim=64, n_layers=2, n_heads=4, n_kv_heads=2)
    batch = {"tokens": inputs["tokens"]}

    def conf(**off):
        return {"train_batch_size": 8,
                "zero_optimization": {"stage": 3, "offload_optimizer": dict(
                    {"device": "cpu", "scheduled": True}, **off)},
                "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
                "bf16": {"enabled": True}}

    def run(name, c, **kw):
        eng = initialize(loss_fn=tl.loss_fn(cfg), params=_tree_params(
            inputs, "llama"), config=c, device="cpu", **kw)[0]
        out[f"{name}/losses"] = np.asarray(
            [float(eng.train_batch(batch)) for _ in range(2)])
        out.put(f"{name}/master", eng.master_params())
        out[f"{name}/tier_bytes"] = np.asarray(eng.tier_local_bytes())
        return eng

    eng = run("device", conf())
    run("host", conf(update="host"))
    nv = os.path.join(spec["dir"], "nv")
    run("nvme", conf(device="nvme", nvme_path=nv))
    out["nvme/dirs"] = np.asarray(sorted(os.listdir(nv)))
    ck = os.path.join(spec["dir"], "ck")
    eng.save_checkpoint(ck)
    back = initialize(loss_fn=tl.loss_fn(cfg), params=_tree_params(
        inputs, "llama"), config=conf(), device="cpu")[0]
    back.load_checkpoint(ck)
    out["ckpt/pair"] = np.asarray([float(eng.train_batch(batch)),
                                   float(back.train_batch(batch))])
    if W == 2:
        _use_mesh({"model": 2})
        run("tp", dict(conf(), mesh={"model": 2}),
            param_specs=tl.param_specs(cfg))


def _suite_zi_tp(out, spec, inputs, W, r):
    """ZeRO-Inference over model = 2 (tiny Llama: bf16 weights in f32,
    int8 weights, the NVMe tier) and over expert = 2 (tiny Mixtral), each
    rank's streamed bytes and KV heads."""
    import torch

    from deepspeed_tpu_torch.inference.serving import (
        llama_serving_engine, mixtral_serving_engine)
    from deepspeed_tpu_torch.models import llama as tl
    from deepspeed_tpu_torch.models import mixtral as tm

    kw = dict(spec["kw"], device="cpu", cache_dtype=torch.float32)
    cfg = tl.LlamaConfig.tiny(dim=64, n_layers=2, n_heads=4, n_kv_heads=2)
    params = _tree_params(inputs, "llama")
    ms = _use_mesh({"model": 2})
    runs = {"bf16": {}, "int8": dict(weight_dtype="int8",
                                     quant_group_size=16),
            "nvme": {"tier": "nvme",
                     "nvme_path": os.path.join(spec["dir"], "zi")}}
    for name, extra in runs.items():
        zi = {"enabled": True, **{k: v for k, v in extra.items()
                                  if k in ("tier", "nvme_path")}}
        wkw = {k: v for k, v in extra.items() if k not in zi}
        eng = llama_serving_engine(params, cfg, mesh=ms, zero_inference=zi,
                                   **dict(kw, **wkw))
        _put_tokens(out, name, _serve(eng, spec["prompts"]))
        out[f"{name}/heads"] = np.asarray(eng.cache.k.shape[1])
        out[f"{name}/layer_bytes"] = np.asarray(eng.plan["layer_bytes"])
        out[f"{name}/uploaded"] = np.asarray(eng.zi_bytes_uploaded)
        assert eng.check_leaks() == []
    mcfg = tm.MixtralConfig.tiny(attn_impl="reference")
    ems = _use_mesh({"expert": 2})
    eng = mixtral_serving_engine(_tree_params(inputs, "mixtral"), mcfg,
                                 mesh=ems, zero_inference={"enabled": True},
                                 **kw)
    _put_tokens(out, "moe", _serve(eng, spec["prompts"]))
    out["moe/layer_bytes"] = np.asarray(eng.plan["layer_bytes"])


SUITES.update({"offload": _suite_offload, "digest": _suite_digest,
               "pstream": _suite_pstream, "infinity": _suite_infinity,
               "zi_tp": _suite_zi_tp})


# ------------------------------------ GPT-2 / BERT TP, injection, hybrid
def _suite_tp_gpt2_bert(out, spec, inputs, W, r):
    """GPT-2 and BERT over ``model`` (W = 2: model 2; W = 4: model 4 for
    serving, data 2 x model 2 for training): GPT-2 tp serving (f32 and
    int8 weights) and ``init_inference`` logits, each rank's fused QKV
    block, GPT-2 training at stages 0-1 (and 2-3 at W = 4) with a stage-0
    checkpoint and remat ``save_attn`` / ``offload_attn``; BERT's pooled /
    MLM / hidden heads over ``model`` (f32 and int8) and its training
    over ``model`` (and data 2 x model 2 at W = 4)."""
    import functools

    import torch

    from deepspeed_tpu_torch.inference import init_inference
    from deepspeed_tpu_torch.inference.encoder_serving import (
        bert_serving_engine)
    from deepspeed_tpu_torch.inference.serving import gpt2_serving_engine
    from deepspeed_tpu_torch.models import bert as tb
    from deepspeed_tpu_torch.models import gpt2 as tg

    cfg = tg.GPT2Config.tiny()
    bcfg = tb.BertConfig.tiny()
    gp = _tree_params(inputs, "gpt2")
    bp = _tree_params(inputs, "bert")
    ms = _use_mesh({"model": W})
    kw = dict(spec["kw"], device="cpu", cache_dtype=torch.float32)
    for name, extra in {"tp": {}, "int8": dict(weight_dtype="int8",
                                               quant_group_size=16),
                        "split": dict(prefill_chunk=4,
                                      decode_chunk=2)}.items():
        eng = gpt2_serving_engine(gp, cfg, mesh=ms, **dict(kw, **extra))
        _put_tokens(out, f"gpt2_{name}", _serve(eng, spec["prompts"]))
        out[f"gpt2_{name}/cache_heads"] = np.asarray(eng.cache.k.shape[1])
        assert eng.check_leaks() == []
        if name == "tp":
            out["gpt2_tp/qkv_w"] = _np(eng.params["blocks"]["qkv_w"])
            out["gpt2_tp/qkv_b"] = _np(eng.params["blocks"]["qkv_b"])
        if name == "int8":
            qt = eng.params["blocks"]["qkv_w"]
            out["gpt2_int8/qkv_q"] = _np(qt.q)
            out["gpt2_int8/qkv_scale"] = _np(qt.scale)
    toks = torch.from_numpy(inputs["fwd_tokens"])
    for dt in ("float32", "int8"):
        ie = init_inference(apply_fn=functools.partial(tg.forward, cfg=cfg),
                            params=gp, mesh=ms,
                            param_specs=tg.param_specs(cfg), dtype=dt,
                            device="cpu", quant_group_size=16)
        out[f"gpt2_ie_{dt}/logits"] = _np(ie(toks))
    lots = [[int(t) for t in q] for q in spec["bert_queue"]]
    for head in ("pooled", "mlm", "hidden"):
        for wdt in ("bfloat16", "int8"):
            eng = bert_serving_engine(bp, bcfg, head=head, mesh=ms,
                                      weight_dtype=wdt, max_batch=2,
                                      quant_group_size=16, device="cpu")
            for i, q in enumerate(lots):
                eng.submit(i, q)
            res = eng.run()
            for i in range(len(lots)):
                out[f"bert_{head}_{wdt}/{i}"] = np.asarray(res[i])
            out[f"bert_{head}_{wdt}/lots"] = np.asarray(eng.stats["lots"])
    # training over model
    sizes = {"model": 2} if W == 2 else {"data": 2, "model": 2}
    batches = [{"tokens": inputs["tokens"][i]}
               for i in range(inputs["tokens"].shape[0])]
    conf = {"train_batch_size": 4, "bf16": {"enabled": False},
            "gradient_clipping": 1.0, "mesh": sizes,
            "optimizer": {"type": "adamw",
                          "params": {"lr": 3e-3, "weight_decay": 0.1}}}
    from deepspeed_tpu_torch import initialize

    for stage in spec["stages"][str(W)]:
        c = dict(conf, zero_optimization={"stage": stage})
        eng = initialize(loss_fn=tg.loss_fn(cfg),
                         params=_tree_params(inputs, "gpt2"), config=c,
                         param_specs=tg.param_specs(cfg), device="cpu")[0]
        if stage == 0:
            # the gathered tree before a step is the one-rank tree
            out.put("gpt2_train/init", eng.module_params())
        out[f"gpt2_train{stage}/losses"] = np.asarray(
            [float(eng.train_batch(b)) for b in batches])
        out.put(f"gpt2_train{stage}/params", eng.module_params())
        if stage == 0:
            eng.save_checkpoint(os.path.join(spec["dir"], f"gpt2_w{W}"),
                                tag="t")
    for remat in ("save_attn", "offload_attn"):
        rcfg = tg.GPT2Config.tiny(remat=remat)
        c = dict(conf, zero_optimization={"stage": 0})
        eng = initialize(loss_fn=tg.loss_fn(rcfg),
                         params=_tree_params(inputs, "gpt2"), config=c,
                         param_specs=tg.param_specs(rcfg), device="cpu")[0]
        out[f"gpt2_{remat}/losses"] = np.asarray(
            [float(eng.train_batch(b)) for b in batches])
    bb = {k[len("bert_batch/"):]: v for k, v in inputs.items()
          if k.startswith("bert_batch/")}
    # BERT over model = W, then (W = 4) over data 2 x model 2
    c = dict(conf, zero_optimization={"stage": 0}, mesh={"model": W})
    eng = initialize(loss_fn=tb.loss_fn(bcfg), params=bp, config=c,
                     param_specs=tb.param_specs(bcfg), device="cpu")[0]
    out["bert_train/losses"] = np.asarray(
        [float(eng.train_batch({k: torch.from_numpy(v) for k, v in
                                bb.items()})) for _ in range(2)])
    out.put("bert_train/params", eng.module_params())
    if W == 4:
        # over data 2 x model 2, 10 and 15 labels on the data ranks: the
        # MLM mean is over the global microbatch, as JAX's GSPMD step
        ub = {k: torch.from_numpy(v) for k, v in bert_unequal_batch().items()}
        c = dict(conf, zero_optimization={"stage": 0},
                 mesh={"data": 2, "model": 2})
        eng = initialize(loss_fn=tb.loss_fn(bcfg), params=bp, config=c,
                         param_specs=tb.param_specs(bcfg), device="cpu")[0]
        out["bert_train_dm/losses"] = np.asarray(
            [float(eng.train_batch(ub)) for _ in range(2)])
        out.put("bert_train_dm/params", eng.module_params())


SUITES["tp_gpt2_bert"] = _suite_tp_gpt2_bert


def _suite_inj_hybrid(out, spec, inputs, W, r):
    """Over model 2: an injected tiny Llama (through ``from_pretrained``)
    and Mixtral (``inject``, also over expert 2) served by
    ``init_inference(mesh=, param_specs=specs)``; the hybrid engine at
    ``inference_tp_size`` 2 (rollout, step, rollout) and its refusal of
    another size; an engine resolving its batch from an elasticity
    block."""
    import torch

    from deepspeed_tpu_torch import (from_pretrained, init_hybrid_engine,
                                     initialize, inject, save_pretrained)
    from deepspeed_tpu_torch.inference import init_inference
    from deepspeed_tpu_torch.models import llama as tl

    toks = torch.from_numpy(inputs["fwd_tokens"])
    cfg = tl.LlamaConfig.tiny()
    params = _tree_params(inputs, "llama")
    d = os.path.join(spec["dir"], f"hf{r}")
    save_pretrained(params, cfg, d)
    fn, p, icfg, specs = from_pretrained(d, device="cpu",
                                         dtype=torch.float32)
    ms = _use_mesh({"model": 2})
    ie = init_inference(apply_fn=fn, params=p, mesh=ms, param_specs=specs,
                        dtype="float32", device="cpu")
    out["llama/logits"] = _np(ie(toks))
    out["llama/wq_cols"] = np.asarray(ie.params["blocks"]["wq"].shape[-1])
    sd = {k[len("mixtral_sd/"):]: torch.from_numpy(v)
          for k, v in inputs.items() if k.startswith("mixtral_sd/")}
    fn, p, mcfg, specs = inject("MixtralForCausalLM", spec["mixtral_hf"], sd,
                                dtype=torch.float32, device="cpu")
    for axis in ("model", "expert"):
        ms = _use_mesh({axis: 2})
        ie = init_inference(apply_fn=fn, params=p, mesh=ms,
                            param_specs=specs, dtype="float32", device="cpu")
        out[f"mixtral_{axis}/logits"] = _np(ie(toks))
    # hybrid over model 2
    conf = dict(spec["hybrid_conf"], mesh={"model": 2})
    eng = initialize(loss_fn=tl.loss_fn(cfg), params=params, config=conf,
                     param_specs=tl.param_specs(cfg), device="cpu")[0]
    hyb = init_hybrid_engine(eng, cfg, cache_dtype=torch.float32)
    prompts = torch.from_numpy(inputs["prompts"])
    out["hybrid/cache_heads"] = np.asarray(
        hyb._alloc(1, 8).k.shape[-2])
    out["hybrid/before"] = _np(hyb.generate(prompts, max_new_tokens=6,
                                            temperature=0.0))
    out["hybrid/loss"] = np.asarray(float(hyb.train_batch(
        {"tokens": torch.from_numpy(inputs["train_tokens"])})))
    out["hybrid/after"] = _np(hyb.generate(prompts, max_new_tokens=6,
                                           temperature=0.0))
    bad = dict(conf, hybrid_engine=dict(conf["hybrid_engine"],
                                        inference_tp_size=4))
    eng = initialize(loss_fn=tl.loss_fn(cfg), params=params, config=bad,
                     param_specs=tl.param_specs(cfg), device="cpu")[0]
    try:
        init_hybrid_engine(eng, cfg)
        out["hybrid/refused"] = np.asarray("")
    except ValueError as e:
        out["hybrid/refused"] = np.asarray(str(e))
    # elasticity: the batch resolved at world 2 over data, one step
    eng = initialize(loss_fn=tl.loss_fn(cfg), params=params,
                     config=spec["elastic_conf"], device="cpu")[0]
    c = eng.config
    out["elastic/batch"] = np.asarray(
        [c.train_batch_size, c.train_micro_batch_size_per_gpu,
         c.gradient_accumulation_steps])
    rows = torch.from_numpy(inputs["elastic_tokens"][:c.train_batch_size])
    out["elastic/loss"] = np.asarray(float(eng.train_batch(
        {"tokens": rows})))


SUITES["inj_hybrid"] = _suite_inj_hybrid


def _suite_masked_mean(out, spec, inputs, W, r):
    """Masked-mean losses over data = 2 with unequal counts on the ranks:
    tiny BERT's MLM mean (exact step, and under qwZ, qgZ and 1-bit Adam)
    and tiny Llama's packed-document loss, each for ``spec["steps"]``
    steps; recorded as :func:`_train` records them."""
    import torch

    from deepspeed_tpu_torch.models import bert as tb
    from deepspeed_tpu_torch.models import llama as tl

    bcfg, lcfg = tb.BertConfig.tiny(), tl.LlamaConfig.tiny()
    bb = {k[len("bert_batch/"):]: torch.from_numpy(v)
          for k, v in inputs.items() if k.startswith("bert_batch/")}
    lb = {k[len("llama_batch/"):]: torch.from_numpy(v)
          for k, v in inputs.items() if k.startswith("llama_batch/")}
    for name, conf in spec["cases"].items():
        if name.startswith("llama"):
            _train(out, name, conf, _llama_params(inputs), [lb],
                   spec["steps"], loss_fn=tl.loss_fn(lcfg), moments=False)
        else:
            _train(out, name, conf, _tree_params(inputs, "bert"), [bb],
                   spec["steps"], loss_fn=tb.loss_fn(bcfg), moments=False)


SUITES["masked_mean"] = _suite_masked_mean


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
