"""The port's copy of the config schema against the JAX package's: the same
DeepSpeed dicts parse to the same fields, the batch arithmetic solves the
same way, and every dataclass has the same fields with the same defaults.

The intended difference: an enabled ``random_ltd`` block parses in the
JAX package (which validates it in a module the port has not ported) and
raises ``NotImplementedError`` in the port, naming the ROADMAP item; an
enabled ``faults`` block parses in both, its rules validated by each
package's ``FaultPlan``.  An enabled ``curriculum_learning`` block parses in both, into each
package's own ``CurriculumConfig``, and an enabled ``elasticity`` block
into each package's ``ElasticityConfig``, which resolves the batch alike
(its three errors included).  The JAX package's default directories under
``/tmp`` (swap, flight recorder, incidents) sit under the process's temp
directory in the port, the same paths when ``TMPDIR`` is unset."""

import dataclasses
import inspect
import os
import tempfile

import pytest
import torch

from deepspeed_tpu import config as jcfg
from deepspeed_tpu_torch import config as tcfg

torch.set_num_threads(1)

PARSED = {
    "defaults": {},
    "batch-train-micro": {"train_batch_size": 32,
                          "train_micro_batch_size_per_gpu": 4},
    "batch-train-accum": {"train_batch_size": 24,
                          "gradient_accumulation_steps": 3},
    "batch-micro-accum": {"train_micro_batch_size_per_gpu": 2,
                          "gradient_accumulation_steps": 4},
    "batch-all-three": {"train_batch_size": 16,
                        "train_micro_batch_size_per_gpu": 2,
                        "gradient_accumulation_steps": 8},
    "batch-micro-only": {"train_micro_batch_size_per_gpu": 3},
    "batch-accum-only": {"gradient_accumulation_steps": 5},
    "batch-train-only": {"train_batch_size": 12},
    "batch-zero": {"train_batch_size": 0},
    "batch-inconsistent": {"train_batch_size": 10,
                           "train_micro_batch_size_per_gpu": 3,
                           "gradient_accumulation_steps": 2},
    "fp16": {"train_batch_size": 4, "gradient_clipping": 1.0,
             "fp16": {"enabled": True, "loss_scale": 0,
                      "initial_scale_power": 18, "loss_scale_window": 2,
                      "hysteresis": 3, "min_loss_scale": 0.5}},
    "bf16-off": {"bf16": {"enabled": False}},
    "bfloat16-alias": {"bfloat16": {"enabled": True}},
    "optimizer-scheduler": {
        "optimizer": {"type": "AdamW",
                      "params": {"lr": 3e-4, "betas": [0.8, 0.99],
                                 "eps": 1e-6, "weight_decay": 0.1}},
        "scheduler": {"type": "WarmupDecayLR",
                      "params": {"total_num_steps": 100,
                                 "warmup_num_steps": 10}}},
    "fused-adam": {"optimizer": {"type": "FusedAdam",
                                 "params": {"lr": 1e-3}},
                   "scheduler": {"type": "WarmupLR",
                                 "params": {"warmup_num_steps": 0}}},
    "zero-and-model-blocks": {
        "zero_optimization": {"stage": 2, "overlap_comm": True,
                              "offload_optimizer": {"device": "cpu"}},
        "activation_checkpointing": {"enabled": True,
                                     "cpu_checkpointing": True},
        "pipeline": {"stages": 2, "schedule": "gpipe"},
        "moe": {"num_experts": 4, "top_k": 1},
        "mesh": {"data": 2, "model": 2},
        "progressive_layer_drop": {"enabled": True, "theta": 0.5},
        "eigenvalue": {"enabled": True},
        "sparse_attention": {"mode": "fixed"}},
    "serving-blocks": {
        "prefix_cache": {"max_cached_pages": 64},
        "kv_tier": {"host_pool_bytes": 1 << 20},
        "speculative": {"draft_tokens": 3},
        "slo": {"tiers": {"gold": {"ttft_s": 0.5, "target": 0.99}},
                "default_tier": "gold"},
        "telemetry": {"enabled": True, "interval_steps": 5},
        "tracing": {"sample_rate": 0.5}},
    "curriculum_learning": {"curriculum_learning": {
        "enabled": True, "curriculum_type": "seqlen", "min_difficulty": 9,
        "max_difficulty": 33, "schedule_config": {
            "total_curriculum_step": 4, "difficulty_step": 8}}},
    "curriculum_learning-nested": {"data_efficiency": {"data_sampling": {
        "curriculum_learning": {"enabled": True, "min_difficulty": 8,
                                "max_difficulty": 16}}}},
    "disabled-blocks": {
        "faults": {"enabled": False, "rules": []},
        "elasticity": {"enabled": False},
        "curriculum_learning": {"enabled": False},
        "random_ltd": {"enabled": False}},
}

INVALID = {
    "slo-unknown-default-tier": {"slo": {"tiers": {"gold": {"ttft_s": 1}}}},
    "faults-rules-not-a-list": {"faults": {"enabled": False, "rules": 3}},
    "faults-unknown-subsystem": {"faults": {"rules": [
        {"subsystem": "gpu_melt"}]}},
    "faults-latency-without-delay": {"faults": {"rules": [
        {"subsystem": "slot", "mode": "latency"}]}},
    "kv_tier-negative-retries": {"kv_tier": {"io_retries": -1}},
}

RAISES = {
    # ported: parses as the JAX package does (match None)
    "faults": ({"faults": {"seed": 3, "rules": [
        {"subsystem": "aio_read", "rate": 0.5, "count": 2}]}}, None),
    # ported: parses and resolves as the JAX package does (match None)
    "elasticity": ({"elasticity": {
        "enabled": True, "max_train_batch_size": 64,
        "micro_batch_sizes": [2, 4], "min_gpus": 1, "max_gpus": 16}},
        None),
    "random_ltd": ({"random_ltd": {
        "enabled": True, "total_layer_num": 4, "random_ltd_layer_num": 2}},
        "random_ltd"),
}


def _rooted(v):
    """The JAX package's ``/tmp/...`` defaults as the port roots them."""
    if isinstance(v, dict):
        return {k: _rooted(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_rooted(x) for x in v)
    if isinstance(v, str) and v.startswith("/tmp/"):
        return os.path.join(tempfile.gettempdir(), v[len("/tmp/"):])
    return v


def _parse(module, d):
    try:
        got = dataclasses.asdict(module.Config.from_dict(d))
    except Exception as e:            # both packages must fail alike
        return (type(e).__name__, str(e))
    return _rooted(got) if module is jcfg else got


def _resolve(module, d, dp_world):
    c = module.Config.from_dict(d)
    try:
        c.resolve_batch_sizes(dp_world)
    except Exception as e:
        return (type(e).__name__, str(e))
    return (c.train_batch_size, c.train_micro_batch_size_per_gpu,
            c.gradient_accumulation_steps)


@pytest.mark.parametrize("d", PARSED.values(), ids=PARSED.keys())
def test_dict_parses_the_same(d):
    want, got = _parse(jcfg, d), _parse(tcfg, d)
    assert isinstance(want, dict), want
    assert got.keys() == want.keys()
    for field in want:
        assert got[field] == want[field], field
    # PrecisionConfig.is_fp16 is a property, not a field
    assert (tcfg.Config.from_dict(d).precision.is_fp16
            == jcfg.Config.from_dict(d).precision.is_fp16)


@pytest.mark.parametrize("d", INVALID.values(), ids=INVALID.keys())
def test_invalid_dict_fails_the_same(d):
    want = _parse(jcfg, d)
    assert not isinstance(want, dict)
    assert _parse(tcfg, d) == want


@pytest.mark.parametrize("d", [v for k, v in PARSED.items()
                               if k.startswith("batch")],
                         ids=[k for k in PARSED if k.startswith("batch")])
def test_batch_sizes_resolve_the_same(d):
    for dp_world in (1, 2, 4, 0):
        assert _resolve(tcfg, d, dp_world) == _resolve(jcfg, d, dp_world), \
            dp_world


@pytest.mark.parametrize("d,match", RAISES.values(), ids=RAISES.keys())
def test_unported_blocks_raise_where_jax_parses(d, match):
    assert isinstance(_parse(jcfg, d), dict)
    if match is None:
        # a block ported since: it parses and resolves the same
        assert _parse(tcfg, d) == _parse(jcfg, d)
        for dp_world in (1, 2, 4, 7, 0):
            assert _resolve(tcfg, d, dp_world) == \
                _resolve(jcfg, d, dp_world), dp_world
        return
    with pytest.raises(NotImplementedError, match=match):
        tcfg.Config.from_dict(d)


def _dataclasses(module):
    return {n: c for n, c in vars(module).items()
            if inspect.isclass(c) and dataclasses.is_dataclass(c)
            and c.__module__ == module.__name__}


def _default(f):
    if f.default is not dataclasses.MISSING:
        return f.default
    if f.default_factory is not dataclasses.MISSING:
        v = f.default_factory()
        return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
    return dataclasses.MISSING


def test_every_dataclass_and_constant_has_its_twin():
    want, got = _dataclasses(jcfg), _dataclasses(tcfg)
    assert got.keys() == want.keys()
    for name, cls in want.items():
        jf = [(f.name, _rooted(_default(f))) for f in dataclasses.fields(cls)]
        tf = [(f.name, _default(f)) for f in dataclasses.fields(got[name])]
        assert tf == jf, name
    consts = {n for n in vars(jcfg) if n.isupper()}
    assert consts == {n for n in vars(tcfg) if n.isupper()}
    for n in consts:
        assert getattr(tcfg, n) == getattr(jcfg, n), n
