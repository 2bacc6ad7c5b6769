"""Pipeline parallelism of the port (``parallel/pipeline.py``, ``n_micro``
in ``models/llama.py``, ``pipeline.stages`` in the engine) against the JAX
package.

Gloo ranks (W = 2 and 4) are spawned once by ``tests/_torch_dist.py``.
``pipelined_scan`` over pipe = W (4 microbatches, remat none / full /
save_dots) is held to ``lax.scan`` and its gradients at 1e-5
(tests/test_parallel.py:107, :126); the pipelined Llama forward to the
plain one at 2e-4 (tests/test_pipeline_llama.py:33); Llama trained with
pipe 2 (x data 2 at W = 4) and n_micro 4 to the JAX engine on the same
mesh and to the JAX engine with 4 accumulation steps on one device, at
5e-4 (tests/test_pipeline_llama.py:66).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
import deepspeed_tpu as dstpu
from deepspeed_tpu import topology as jtopo
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.parallel import pipeline as jpipe
from deepspeed_tpu.topology import MeshSpec as JMesh
from deepspeed_tpu_torch.parallel import pipeline as tpipe

torch.set_num_threads(1)
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)      # tests/test_parallel.py:107
FWD_TOL = dict(rtol=2e-4, atol=2e-4)       # tests/test_pipeline_llama.py:33
TRAIN_TOL = dict(rtol=5e-4, atol=5e-4)     # tests/test_pipeline_llama.py:66
STEPS = 3


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.default_rng(5)
    L, d, B = 4, 16, 8
    w = (rng.normal(0, 1, (L, d, d)) / np.sqrt(d)).astype(np.float32)
    x = rng.normal(0, 1, (B, d)).astype(np.float32)
    cfg = jl.LlamaConfig.tiny(attn_impl="reference", n_layers=4)
    jp = jax.device_get(jl.init_params(jax.random.PRNGKey(0), cfg))
    toks = rng.integers(0, cfg.vocab_size, (8, 17)).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (STEPS, 16, 17)).astype(
        np.int32)
    return {"pp_w": w, "pp_x": x, "llama": jp, "fwd_tokens": toks,
            "tokens": tokens}, cfg


@pytest.fixture(scope="module")
def runs():
    import concurrent.futures as cf

    arrays, _ = _inputs()
    with cf.ThreadPoolExecutor(2) as ex:
        futs = {W: ex.submit(td.run_ranks, "pp", W, {}, arrays)
                for W in (2, 4)}
        return {W: f.result() for W, f in futs.items()}


def _block(x, lp):
    return jnp.tanh(x @ lp["w"]) + x, None


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("remat", ["none", "full", "save_dots"])
def test_pipelined_scan_matches_scan(runs, W, remat):
    a, _ = _inputs()
    w, x = jnp.asarray(a["pp_w"]), jnp.asarray(a["pp_x"])

    def loss(w, x):
        y, _ = jax.lax.scan(_block, x, {"w": w})
        return jnp.sum(y ** 2)

    want, _ = jax.lax.scan(_block, x, {"w": w})
    dw, dx = jax.grad(loss, argnums=(0, 1))(w, x)
    for o in runs[W]:
        np.testing.assert_allclose(o[f"scan/{remat}/y"], want, **SCAN_TOL)
        np.testing.assert_allclose(o[f"scan/{remat}/dx"], dx, **SCAN_TOL)
    got_dw = np.concatenate([o[f"scan/{remat}/dw"] for o in runs[W]])
    np.testing.assert_allclose(got_dw, dw, **SCAN_TOL)


@pytest.mark.parametrize("W", [2, 4])
def test_llama_pipelined_forward_matches(runs, W):
    a, cfg = _inputs()
    want = jl.forward(jax.tree.map(jnp.asarray, a["llama"]),
                      jnp.asarray(a["fwd_tokens"]), cfg)
    for o in runs[W]:
        np.testing.assert_allclose(o["llama/logits"], np.asarray(want),
                                   **FWD_TOL)


@functools.lru_cache(maxsize=None)
def _jax_train(sizes, n_micro):
    a, cfg = _inputs()
    sizes = dict(sizes)
    n = int(np.prod(list(sizes.values())))
    jtopo.set_current_mesh(None)
    try:
        eng, _, _, _ = dstpu.initialize(
            loss_fn=jl.loss_fn(cfg, n_micro=n_micro),
            params=jax.tree.map(jnp.asarray, a["llama"]),
            mesh=JMesh.build(sizes, devices=jax.devices()[:n]),
            config={"train_batch_size": 16,
                    "gradient_accumulation_steps": 4, "mesh": sizes,
                    "pipeline": {"stages": sizes.get("pipe", 1)},
                    "zero_optimization": {"stage": 0},
                    "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
                    "bf16": {"enabled": False}},
            param_specs=jl.param_specs(cfg, pipeline=sizes.get(
                "pipe", 1) > 1))
        return [float(eng.train_batch({"tokens": jnp.asarray(t)}))
                for t in a["tokens"]]
    finally:
        jtopo.set_current_mesh(None)


@pytest.mark.parametrize("W", [2, 4])
def test_pipelined_training_matches_jax(runs, W):
    sizes = (("pipe", 2),) if W == 2 else (("pipe", 2), ("data", 2))
    got = [o["train/trace"][:, 0] for o in runs[W]]
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])
    np.testing.assert_allclose(got[0], _jax_train(sizes, 4), **TRAIN_TOL)
    # PP with 4 microbatches == one device with 4 accumulation steps
    np.testing.assert_allclose(got[0], _jax_train((("data", 1),), None),
                               **TRAIN_TOL)


def test_partition_and_schedule_match_jax():
    for L, S in ((8, 2), (8, 4), (12, 3)):
        assert tpipe.uniform_partition(L, S) == jpipe.uniform_partition(L, S)
    with pytest.raises(ValueError, match="divisible"):
        tpipe.uniform_partition(7, 2)
    for M, S in ((4, 2), (8, 4), (1, 1)):
        assert tpipe.PipelineSchedule.n_ticks(M, S) == \
            jpipe.PipelineSchedule.n_ticks(M, S)
        assert tpipe.PipelineSchedule.bubble_fraction(M, S) == \
            jpipe.PipelineSchedule.bubble_fraction(M, S)
    from jax.sharding import PartitionSpec as P

    for base in (None, P(None, "model"), P("pipe", None)):
        assert tpipe.stage_spec(None if base is None else tuple(base)) == \
            tuple(jpipe.stage_spec(base))
