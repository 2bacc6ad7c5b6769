"""The port's elasticity and autotune modules (``deepspeed_tpu_torch/
elasticity.py``, ``autotune.py``) against the JAX package's: the JAX test
cases of tests/test_launcher_elastic_autotune.py run against both packages
(exact: integer arithmetic and the same candidates), plus what the port
adds: a candidate fails only for an out-of-memory error or a config or
engine refusal, so a kernel's error propagates out of ``tune()``, and
``autotune_config(loss_for=...)`` hands each candidate's remat policy to
the model (an unknown policy is a failed candidate)."""

import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu import autotune as jat
from deepspeed_tpu import elasticity as jel
from deepspeed_tpu.config import Config as JConfig
from deepspeed_tpu_torch import autotune as tat
from deepspeed_tpu_torch import elasticity as tel
from deepspeed_tpu_torch.config import Config as TConfig

torch.set_num_threads(1)
EL = {"jax": (jel, JConfig), "torch": (tel, TConfig)}
AT = {"jax": (jat, jnp.zeros, MemoryError),
      "torch": (tat, torch.zeros, torch.OutOfMemoryError)}


@pytest.fixture(params=["jax", "torch"])
def el(request):
    return EL[request.param]


@pytest.fixture(params=["jax", "torch"])
def at(request):
    return AT[request.param]


# ---------------------------------------------------------------- elasticity
def test_get_valid_gpus(el):
    mod, _ = el
    assert mod.get_valid_gpus(12, [2, 3], min_gpus=1, max_gpus=100) == \
        [1, 2, 3, 4, 6]
    assert mod.get_valid_gpus(7, [2], 1, 100) == []


def test_best_candidate_prefers_coverage_then_size(el):
    mod, _ = el
    b, gpus = mod.get_best_candidate_batch_size(
        24, [2, 4], min_gpus=1, max_gpus=100, prefer_larger=True)
    assert (b, gpus) == jel.get_best_candidate_batch_size(
        24, [2, 4], min_gpus=1, max_gpus=100, prefer_larger=True)
    assert b in range(2, 25) and b % 2 == 0
    for g in gpus:
        assert any(b % (mb * g) == 0 for mb in [2, 4])
    with pytest.raises(ValueError, match="no valid"):
        mod.get_best_candidate_batch_size(1, [2], 1, 4)


def test_compute_elastic_config_resolves_run(el):
    mod, _ = el
    cfg = mod.ElasticityConfig(enabled=True, max_train_batch_size=64,
                               micro_batch_sizes=[2, 4], min_gpus=1,
                               max_gpus=16)
    out = mod.compute_elastic_config(cfg)
    assert out == jel.compute_elastic_config(jel.ElasticityConfig(
        enabled=True, max_train_batch_size=64, micro_batch_sizes=[2, 4],
        min_gpus=1, max_gpus=16))
    assert out["train_batch_size"] <= 64 and out["valid_gpus"]
    ws = out["valid_gpus"][-1]
    run = mod.compute_elastic_config(cfg, world_size=ws)
    mb, ga = (run["train_micro_batch_size_per_gpu"],
              run["gradient_accumulation_steps"])
    assert mb * ga * ws == run["train_batch_size"]
    with pytest.raises(ValueError):
        mod.compute_elastic_config(cfg, world_size=max(out["valid_gpus"])
                                   * 2 + 1)


def test_elasticity_applied_in_config_resolution(el):
    mod, Config = el
    block = {"enabled": True, "max_train_batch_size": 64,
             "micro_batch_sizes": [2, 4], "min_gpus": 1, "max_gpus": 16}
    cfg = Config.from_dict({"elasticity": dict(block)})
    assert cfg.elasticity is not None
    ws = mod.compute_elastic_config(cfg.elasticity)["valid_gpus"][-1]
    cfg.resolve_batch_sizes(ws)
    assert (cfg.train_micro_batch_size_per_gpu
            * cfg.gradient_accumulation_steps * ws == cfg.train_batch_size)
    bad = Config.from_dict({"elasticity": dict(block)})
    with pytest.raises(ValueError):
        bad.resolve_batch_sizes(7 * ws + 1)
    # re-resolution is idempotent
    cfg.resolve_batch_sizes(ws)
    assert (cfg.train_micro_batch_size_per_gpu
            * cfg.gradient_accumulation_steps * ws == cfg.train_batch_size)
    conflicted = Config.from_dict({
        "train_batch_size": 32,
        "elasticity": {"enabled": True, "max_train_batch_size": 64,
                       "micro_batch_sizes": [2, 4]}})
    with pytest.raises(ValueError, match="elastic"):
        conflicted.resolve_batch_sizes(ws)


def test_mesh_factorizations(el):
    mod, _ = el
    shapes = mod.mesh_factorizations(8)
    assert shapes == jel.mesh_factorizations(8)
    assert {"data": 8, "model": 1} in shapes
    assert {"data": 1, "model": 8} in shapes
    assert all(s["model"] <= 2 for s in mod.mesh_factorizations(
        8, max_model=2))


# ------------------------------------------------------------------ autotune
def test_expand_space_and_set_by_path(at):
    mod, _, _ = at
    combos = mod.expand_space({"a.b": [1, 2], "c": ["x"]})
    assert len(combos) == 2 and {"a.b": 1, "c": "x"} in combos
    d = {}
    mod.set_by_path(d, "zero_optimization.stage", 3)
    assert d == {"zero_optimization": {"stage": 3}}
    assert mod.DEFAULT_SPACE == jat.DEFAULT_SPACE
    assert mod._space_key({"a": [1]}, "x") == jat._space_key({"a": [1]}, "x")


def test_autotuner_picks_fastest_and_caches(at, tmp_path):
    mod, zeros, _ = at
    calls = []

    def build(ov):
        delay = ov["delay"]
        calls.append(delay)

        def step():
            time.sleep(delay)
            return zeros(())
        return step

    cache = str(tmp_path / "cache.json")
    cands = [{"delay": 0.03}, {"delay": 0.001}]
    out = mod.Autotuner(build, cands, cache_path=cache, iters=2,
                        warmup=1).tune()
    assert out["overrides"] == {"delay": 0.001}
    n = len(calls)
    out2 = mod.Autotuner(build, cands, cache_path=cache, iters=2,
                         warmup=1).tune()
    assert out2["overrides"] == {"delay": 0.001} and len(calls) == n


def test_autotuner_skips_failed_candidates(at):
    mod, zeros, oom = at

    def build(ov):
        if ov["bad"]:
            raise oom("oom")
        return lambda: zeros(())

    out = mod.Autotuner(build, [{"bad": True}, {"bad": False}],
                        cache_path=None, iters=1, warmup=0).tune()
    assert out["overrides"] == {"bad": False}
    assert any("error" in r for r in out["results"])


@pytest.mark.parametrize("err", [RuntimeError("fused_adam: nvcc failed"),
                                 MemoryError("host"), KeyError("x")])
def test_kernel_error_inside_a_candidate_propagates(err):
    """Only OOM and config / engine refusals mark a candidate failed; any
    other error (a kernel that does not build or launch) leaves tune()."""
    def build(ov):
        if ov["kernel"]:
            def step():
                raise err
            return step
        return lambda: torch.zeros(())

    with pytest.raises(type(err)):
        tat.Autotuner(build, [{"kernel": False}, {"kernel": True}],
                      cache_path=None, iters=1, warmup=0).tune()
    for refusal in (ValueError("bad mesh"), NotImplementedError("no")):
        def refuse(ov, refusal=refusal):
            if ov["kernel"]:
                raise refusal
            return lambda: torch.zeros(())

        out = tat.Autotuner(refuse, [{"kernel": True}, {"kernel": False}],
                            cache_path=None, iters=1, warmup=0).tune()
        assert out["overrides"] == {"kernel": False}


def test_autotune_config_end_to_end(tmp_path):
    rng = np.random.RandomState(0)
    w = rng.randn(8, 4).astype(np.float32)
    x = rng.randn(16, 8).astype(np.float32)
    y = rng.randn(16, 4).astype(np.float32)
    base = {"train_batch_size": 16,
            "optimizer": {"type": "sgd", "params": {"lr": 0.1}}}
    space = {"zero_optimization.stage": [0, 2]}

    def tloss(p, b):
        return torch.mean((b["x"] @ p["w"].float() - b["y"]) ** 2)

    verdict = tat.autotune_config(
        base, tloss, {"w": torch.from_numpy(w)},
        {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, space=space,
        cache_path=str(tmp_path / "c.json"), iters=2, device="cpu")
    assert verdict["overrides"]["zero_optimization.stage"] in (0, 2)
    assert verdict["config"]["train_batch_size"] == 16
    assert "zero_optimization" in verdict["config"]
    assert len(verdict["results"]) == 2

    def jloss(p, b):
        return jnp.mean((b["x"] @ p["w"].astype(jnp.float32) - b["y"]) ** 2)

    jv = jat.autotune_config(base, jloss, {"w": jnp.asarray(w)},
                             {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                             space=space, cache_path=None, iters=2)
    assert [r["overrides"] for r in jv["results"]] == \
        [r["overrides"] for r in verdict["results"]]


def test_autotune_config_remat_candidates(tmp_path):
    from deepspeed_tpu_torch.models import gpt2 as tg
    from deepspeed_tpu_torch.weights import init_params

    cfg = tg.GPT2Config.tiny(n_layers=1)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (4, 9)).astype(np.int64))
    base = {"train_batch_size": 4, "bf16": {"enabled": False},
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}
    space = {"train_micro_batch_size_per_gpu": [2, 4],
             "activation_checkpointing.policy": ["none", "full", "bogus"]}
    cache = str(tmp_path / "remat.json")
    def loss_for(policy):
        return tg.loss_fn(dataclasses.replace(cfg, remat=policy))

    verdict = tat.autotune_config(base, tg.loss_fn(cfg), params,
                                  {"tokens": toks}, space=space,
                                  cache_path=cache, iters=1, device="cpu",
                                  loss_for=loss_for)
    failed = [r for r in verdict["results"] if "error" in r]
    timed = [r for r in verdict["results"] if "step_time_s" in r]
    assert len(failed) == 2 and len(timed) == 4
    assert all("bogus" in r["error"] for r in failed)
    assert verdict["step_time_s"] == min(r["step_time_s"] for r in timed)
    # the second call hits the cache: no engine is built
    built = []
    orig = tat.Autotuner._measure
    tat.Autotuner._measure = lambda self, ov: built.append(ov) or 0.0
    try:
        again = tat.autotune_config(base, tg.loss_fn(cfg), params,
                                    {"tokens": toks}, space=space,
                                    cache_path=cache, iters=1, device="cpu",
                                    loss_for=loss_for)
    finally:
        tat.Autotuner._measure = orig
    assert built == [] and again["overrides"] == verdict["overrides"]
