"""ZeRO offload's routing and host placement in the port, on the CPU.

``initialize`` routes as the JAX package's does: a ``LayeredModel`` or a
scheduled / NVMe ``offload_param`` block to ``ParamStreamEngine``, a
scheduled / NVMe ``offload_optimizer`` block to ``InfinityEngine``, the
unscheduled ``cpu`` blocks to the stage-0 ``TrainingEngine``, whose state
they place in (page-locked) host memory: that engine's losses and params
equal the same engine without the block bit for bit.  Every refusal
carries the JAX package's message, held string for string against it (no
JAX engine is built: each refusal comes before one would be).  The port's
``NvmeSwapper`` writes one file per leaf equal to ``ndarray.tofile`` of
it, and reads the tree back bit for bit."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.ops import optim as jopt
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch import param_stream as tps
from deepspeed_tpu_torch._tree import tree_leaves
from deepspeed_tpu_torch.engine import TrainingEngine
from deepspeed_tpu_torch.infinity import InfinityEngine
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.offload import NvmeSwapper, offload_placement
from deepspeed_tpu_torch.ops import optim as topt
from deepspeed_tpu_torch.ops.adam_cuda import fused_adam
from deepspeed_tpu_torch.param_stream import ParamStreamEngine
from deepspeed_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)
CFG = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2)
SCHED = {"device": "cpu", "scheduled": True}


@pytest.fixture(scope="module")
def model():
    cfg = jl.LlamaConfig.tiny(**CFG)
    jp = jax.device_get(jl.init_params(jax.random.PRNGKey(0), cfg))
    return cfg, tl.LlamaConfig.tiny(**CFG), jp


def _conf(zero=None, **over):
    conf = {"train_micro_batch_size_per_gpu": 2,
            "zero_optimization": {"stage": 0, **(zero or {})},
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "bf16": {"enabled": True}}
    conf.update(over)
    return conf


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


CURRICULUM = {"enabled": True, "curriculum_type": "seqlen",
              "min_difficulty": 8, "max_difficulty": 16,
              "schedule_config": {"total_curriculum_step": 2,
                                  "difficulty_step": 8}}


@pytest.mark.parametrize("case", [
    "plain_tree_scheduled_param", "layered_with_optimizer",
    "layered_with_aux", "infinity_with_optimizer", "infinity_curriculum",
    "no_loss_fn", "layered_not_adam", "infinity_bad_update"])
def test_routing_refusals_match_jax(model, case):
    cfg, tcfg, jp = model
    jparams, tparams = jax.tree.map(jnp.asarray, jp), \
        from_jax_params(jp, device="cpu")
    jlm = jl.layered_model(cfg, jparams)
    tlm = tl.layered_model(tcfg, tparams)
    if case == "plain_tree_scheduled_param":
        conf = _conf({"offload_param": SCHED})
        jkw = dict(loss_fn=jl.loss_fn(cfg), params=jparams)
        tkw = dict(loss_fn=tl.loss_fn(tcfg), params=tparams)
    elif case in ("layered_with_optimizer", "layered_with_aux"):
        conf = _conf({"offload_param": SCHED})
        jkw, tkw = dict(params=jlm), dict(params=tlm)
        if case == "layered_with_aux":
            jkw["has_aux"] = tkw["has_aux"] = True
        else:
            jkw["optimizer"], tkw["optimizer"] = jopt.adam(), topt.adam()
    elif case == "infinity_with_optimizer":
        conf = _conf({"offload_optimizer": SCHED})
        jkw = dict(loss_fn=jl.loss_fn(cfg), params=jparams,
                   optimizer=jopt.adam())
        tkw = dict(loss_fn=tl.loss_fn(tcfg), params=tparams,
                   optimizer=topt.adam())
    elif case == "infinity_curriculum":
        conf = _conf({"offload_optimizer": SCHED},
                     curriculum_learning=CURRICULUM)
        jkw = dict(loss_fn=jl.loss_fn(cfg), params=jparams)
        tkw = dict(loss_fn=tl.loss_fn(tcfg), params=tparams)
    elif case == "no_loss_fn":
        conf = _conf()
        jkw, tkw = dict(params=jparams), dict(params=tparams)
    elif case == "layered_not_adam":
        conf = _conf({"offload_param": SCHED},
                     optimizer={"type": "lamb", "params": {"lr": 1e-3}})
        jkw, tkw = dict(params=jlm), dict(params=tlm)
    else:
        conf = _conf({"offload_optimizer": {**SCHED, "update": "gpu"}})
        jkw = dict(loss_fn=jl.loss_fn(cfg), params=jparams)
        tkw = dict(loss_fn=tl.loss_fn(tcfg), params=tparams)
    want = _message(lambda: dstpu.initialize(config=dict(conf), **jkw))
    got = _message(lambda: initialize(config=dict(conf), device="cpu",
                                      **tkw))
    assert got == want


def test_routes(model):
    _, tcfg, jp = model
    tp = from_jax_params(jp, device="cpu")
    lf = tl.loss_fn(tcfg)
    route = lambda zero, **kw: type(initialize(  # noqa: E731
        config=_conf(zero), device="cpu", **kw)[0])
    assert route({}, params=tl.layered_model(tcfg, tp)) is ParamStreamEngine
    assert route({"offload_param": SCHED},
                 params=tl.layered_model(tcfg, tp)) is ParamStreamEngine
    assert route({"offload_optimizer": SCHED}, loss_fn=lf,
                 params=tp) is InfinityEngine
    # a zero.Init thunk is materialized for the Infinity engine
    assert route({"offload_optimizer": SCHED}, loss_fn=lf,
                 params=lambda: tp) is InfinityEngine
    for zero in ({"offload_optimizer": {"device": "cpu"}},
                 {"offload_param": {"device": "cpu"}}, {}):
        assert route(zero, loss_fn=lf, params=tp) is TrainingEngine
    with pytest.raises(NotImplementedError, match="init thunks"):
        route({}, loss_fn=lf, params=lambda: tp)


def test_distributed_paths_raise_naming_a9(model, monkeypatch):
    from deepspeed_tpu_torch.config import Config

    _, tcfg, jp = model
    tp = from_jax_params(jp, device="cpu")
    conf = Config.from_dict(_conf({"offload_param": SCHED}))
    with pytest.raises(NotImplementedError, match="A9"):
        ParamStreamEngine(tl.layered_model(tcfg, tp), conf, device="cpu",
                          param_specs={"embed": None})
    with pytest.raises(NotImplementedError, match="A9"):
        initialize(params=tl.layered_model(tcfg, tp), config=_conf(),
                   param_specs={"embed": None}, device="cpu")
    monkeypatch.setattr(tps, "process_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="A9"):
        ParamStreamEngine(tl.layered_model(tcfg, tp), conf, device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        InfinityEngine(tl.loss_fn(tcfg), tp, Config.from_dict(
            _conf({"offload_optimizer": SCHED})), device="cpu")


@pytest.mark.parametrize("block,opt", [
    ({"offload_optimizer": {"device": "cpu"}}, "adamw"),
    ({"offload_optimizer": {"device": "cpu", "pin_memory": True}},
     "fused_adam"),
    ({"offload_param": {"device": "cpu"}}, "adamw"),
    ({"offload_param": {"device": "cpu"},
      "offload_optimizer": {"device": "cpu"}}, "adamw")])
def test_unscheduled_offload_equals_plain_engine(model, block, opt):
    _, tcfg, jp = model
    conf = _conf(gradient_accumulation_steps=2, gradient_clipping=1.0)
    runs = []
    for zero in ({}, block):
        eng = initialize(loss_fn=tl.loss_fn(tcfg),
                         params=from_jax_params(jp, device="cpu"),
                         config=_conf(zero, **{
                             k: conf[k] for k in (
                                 "gradient_accumulation_steps",
                                 "gradient_clipping")}),
                         optimizer=(fused_adam(weight_decay=0.01)
                                    if opt == "fused_adam" else None),
                         device="cpu")[0]
        toks = np.random.default_rng(0).integers(0, 256, (4, 17))
        losses = [float(eng.train_batch({"tokens": toks.astype(np.int32)}))
                  for _ in range(3)]
        runs.append((losses, eng))
    (lp, plain), (lo, off) = runs
    assert lo == lp
    for a, b in zip(tree_leaves(off.state), tree_leaves(plain.state)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    place = offload_placement(off.config)
    assert off._host_master == place["master"]
    assert off._host_opt == place["optimizer"]
    assert off._pinned and not plain._pinned


def test_nvme_swapper_files_and_roundtrip(tmp_path):
    tree = {"a": np.arange(100, dtype=np.float32).reshape(10, 10),
            "b": {"c": np.arange(7, dtype=np.int32),
                  "d": torch.randn(3, 5).to(torch.bfloat16)}}
    sw = NvmeSwapper(str(tmp_path / "swap"))
    sw.swap_out(tree, prefix="opt")
    sw.wait()
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            {"a": tree["a"], "b": {"c": tree["b"]["c"], "d": 0}})[0]:
        name = "opt" + jax.tree_util.keystr(path)
        got = (tmp_path / "swap" / (name.replace("/", "_") + ".bin"))
        want = tmp_path / "want.bin"
        ref = leaf if not isinstance(leaf, int) else \
            tree["b"]["d"].view(torch.int16).numpy()
        ref.tofile(str(want))
        assert got.read_bytes() == want.read_bytes(), name
    like = {"a": np.zeros((10, 10), np.float32),
            "b": {"c": np.zeros(7, np.int32),
                  "d": torch.zeros(3, 5, dtype=torch.bfloat16)}}
    back = sw.swap_in(like, prefix="opt")
    np.testing.assert_array_equal(back["a"], tree["a"])
    np.testing.assert_array_equal(back["b"]["c"], tree["b"]["c"])
    assert torch.equal(back["b"]["d"], tree["b"]["d"])
    assert sorted(os.listdir(tmp_path / "swap")) == [
        "opt['a'].bin", "opt['b']['c'].bin", "opt['b']['d'].bin"]
