"""ZeRO stages 0-3 of the port on a tiny f32 Llama across gloo ranks (W = 2
and 4, one launch each, tests/_torch_dist.py), held to the JAX engine on
the same mesh size: 3 steps of AdamW with weight decay, clipping 1.0,
global batch 8 x 17 tokens.  Losses and ``get_global_grad_norm`` at rtol
1e-5 (f32 sums in another order; every row has the same token count, so
the mean of the ranks' local means is the global mean), params at the JAX
stage test's rtol / atol 2e-3 (tests/test_zero_engine.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
import deepspeed_tpu as dstpu
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.topology import MeshSpec

torch.set_num_threads(1)
RTOL = 1e-5
PARAM_TOL = dict(rtol=2e-3, atol=2e-3)
STEPS = 3


@functools.lru_cache(maxsize=None)
def _inputs():
    cfg = jl.LlamaConfig.tiny()
    jp = jax.device_get(jl.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (STEPS, 8, 17)).astype(np.int32)
    return cfg, jp, tokens


@pytest.fixture(scope="module")
def runs():
    import concurrent.futures as cf

    _, jp, tokens = _inputs()
    arrays = {"llama": jp, "tokens": tokens}
    with cf.ThreadPoolExecutor(2) as ex:
        futs = {W: ex.submit(td.run_ranks, "llama", W, arrays=arrays)
                for W in (2, 4)}
        return {W: f.result() for W, f in futs.items()}


def _jax_run(W, stage):
    cfg, jp, tokens = _inputs()
    conf = {"train_batch_size": 8, "bf16": {"enabled": False},
            "gradient_clipping": 1.0, "zero_optimization": {"stage": stage},
            "optimizer": {"type": "adamw",
                          "params": {"lr": 3e-3, "weight_decay": 0.1}}}
    mesh = MeshSpec.build({"data": W}, devices=jax.devices()[:W])
    eng, _, _, _ = dstpu.initialize(
        loss_fn=jl.loss_fn(cfg), params=jax.tree.map(jnp.asarray, jp),
        config=conf, mesh=mesh)
    rows = []
    for i in range(STEPS):
        loss = float(eng.train_batch({"tokens": jnp.asarray(tokens[i])}))
        rows.append([loss, eng.get_global_grad_norm()])
    return np.asarray(rows), jax.device_get(eng.module_params())


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_llama_stage_matches_jax_engine(runs, W, stage):
    want, jp = _jax_run(W, stage)
    got = runs[W][0][f"stage{stage}/trace"]
    for r in range(1, W):
        np.testing.assert_array_equal(runs[W][r][f"stage{stage}/trace"], got)
    np.testing.assert_allclose(got[:, :2], want, rtol=RTOL)
    flat = td._flatten(jp)
    for k, v in flat.items():
        np.testing.assert_allclose(runs[W][0][f"stage{stage}/params/{k}"], v,
                                   err_msg=k, **PARAM_TOL)
