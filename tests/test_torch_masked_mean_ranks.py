"""Masked-mean losses over data ranks (ROADMAP C-f7) against the JAX
engine on the same mesh of its virtual CPU devices.

Two gloo ranks (one launch, tests/_torch_dist.py) train with ``data`` = 2
on batches whose counted positions split unequally over the ranks:

- tiny BERT's MLM mean with 10 labels on rank 0's rows and 15 on rank 1's;
- tiny Llama's packed-document loss, whose ``segment_ids`` put three
  documents and padding in rank 0's rows and one document in rank 1's.

The exact step takes the mean over the whole microbatch (the count summed
over the ranks before the division), as the JAX engine's GSPMD step does:
losses at rtol 1e-4, parameters after two AdamW steps at the one-device
BERT test's rtol 1e-3 / atol 1e-4 (tests/test_torch_train_bert.py).  The
compressed steps are in test_torch_masked_mean_compressed.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
import deepspeed_tpu as dstpu
from deepspeed_tpu.models import bert as jb
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.topology import MeshSpec as JMesh

torch.set_num_threads(1)
W = 2
STEPS = 2
LOSS_TOL = dict(rtol=1e-4)
PARAM_TOL = dict(rtol=1e-3, atol=1e-4)      # tests/test_torch_train_bert.py
# 1-bit Adam's warmup averages the ranks' Adam moments: a near-zero
# gradient's normalised step moves with f32 reordering (read 1.7e-4 on one
# of 32768 elements), so its parameters are held to one step of lr
ONEBIT_TOL = dict(rtol=1e-3, atol=3e-3)


def _conf(zero=None, opt="adamw", opt_params=None):
    return {"train_batch_size": 4, "bf16": {"enabled": False},
            "mesh": {"data": W},
            "optimizer": {"type": opt, "params": opt_params
                          or {"lr": 3e-3, "weight_decay": 0.1}},
            "zero_optimization": zero or {"stage": 0}}


CASES = {"bert_exact": _conf(), "llama_packed": _conf()}


def _llama_batch():
    rng = np.random.default_rng(12)
    B, T = 4, 17
    seg = np.zeros((B, T), np.int32)
    # rank 0: three documents and padding; rank 1: one document a row
    seg[0, :5], seg[0, 5:11], seg[0, 11:14] = 1, 2, 3
    seg[1, :3], seg[1, 3:9] = 1, 2
    seg[2, :], seg[3, :] = 1, 1
    toks = rng.integers(1, 256, (B, T)).astype(np.int32) * (seg > 0)
    return {"tokens": toks, "segment_ids": seg}


@functools.lru_cache(maxsize=None)
def _inputs():
    bp = td.numpy_params(jb.init_params, jb.BertConfig.tiny(), seed=1)
    lp = td.numpy_params(jl.init_params, jl.LlamaConfig.tiny(), seed=2)
    return bp, lp, td.bert_unequal_batch(), _llama_batch()


def start_ranks(cases):
    """The ranks' results for ``cases``, a future: the JAX runs go on
    meanwhile."""
    import concurrent.futures as cf

    bp, lp, bb, lb = _inputs()
    with cf.ThreadPoolExecutor(1) as ex:
        yield ex.submit(
            td.run_ranks, "masked_mean", W,
            spec={"cases": cases, "steps": STEPS},
            arrays={"bert": bp, "llama": lp, "bert_batch": bb,
                    "llama_batch": lb}, timeout=150)


@pytest.fixture(scope="module")
def runs():
    yield from start_ranks(CASES)


def jax_run(name, conf):
    bp, lp, bb, lb = _inputs()
    if name.startswith("llama"):
        loss, p0, batch = jl.loss_fn(jl.LlamaConfig.tiny()), lp, lb
    else:
        loss, p0, batch = jb.loss_fn(jb.BertConfig.tiny()), bp, bb
    eng = dstpu.initialize(
        loss_fn=loss, params=jax.tree.map(jnp.asarray, p0),
        config=dict(conf),
        mesh=JMesh.build({"data": W}, devices=jax.devices()[:W]))[0]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = [float(eng.train_batch(jbatch)) for _ in range(STEPS)]
    return (np.asarray(losses), eng.grad_comm_mode,
            td._flatten(jax.device_get(eng.module_params())))


def test_counts_are_unequal_over_the_ranks():
    _, _, bb, lb = _inputs()
    lab = bb["mlm_labels"] >= 0
    assert (int(lab[:2].sum()), int(lab[2:].sum())) == (10, 15)
    seg = lb["segment_ids"]
    doc = (seg[:, :-1] == seg[:, 1:]) & (seg[:, :-1] > 0)
    assert int(doc[:2].sum()) != int(doc[2:].sum())


def check_against_jax(runs, name, conf):
    want, mode, jp = jax_run(name, conf)
    runs = runs.result()
    got = runs[0][f"{name}/trace"][:, 0]
    for o in runs[1:]:
        np.testing.assert_array_equal(o[f"{name}/trace"][:, 0], got)
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    tol = ONEBIT_TOL if mode == "onebit" else PARAM_TOL
    for k, v in jp.items():
        np.testing.assert_allclose(runs[0][f"{name}/params/{k}"], v,
                                   err_msg=f"{name} ({mode}) {k}", **tol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_masked_mean_over_data_ranks_matches_jax(runs, name):
    check_against_jax(runs, name, CASES[name])
