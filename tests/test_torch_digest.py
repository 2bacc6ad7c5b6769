"""The port's collective digest (``comm/digest.py``, ``TrainingEngine.
comms_digest``, ``InfinityEngine.comms_digest``) against the JAX package's
(tests/test_comm.py's digest tests as the model).

The dict has the JAX digest's keys and kind names.  Its counts and bytes
are the comms logger's over one dry step, and equal what each stage moves
(two gloo ranks, suite ``digest`` of tests/_torch_dist.py; the MLP of
tests/test_zero_engine.py, f32): the grads all-reduced (stages 0-1) or
reduce-scattered (2-3) whole, the new master shards all-gathered (stages
1-2) or the compute tree gathered (3), and three small all-reduces (the
loss, the vector of sums of squares, the overflow flag); fp16 exchanges
its grads in fp16.  The Infinity engine's: each leaf's grads reduce-
scattered into its ``[dp, chunk]`` row, the loss and the row check's two
sums all-reduced, each leaf's compute rows all-gathered.  An engine that
takes a digest before every step runs the trajectory of one that does not,
bit for bit (losses and every state tensor)."""

import numpy as np
import pytest
import torch

import _torch_dist as td
from deepspeed_tpu.comm import digest as jdigest
from deepspeed_tpu_torch import zero
from deepspeed_tpu_torch.comm import digest as tdigest

torch.set_num_threads(1)
W = 2
NAMES = ["stage0", "stage1", "stage2", "stage3", "stage2_off", "fp16", "qgz"]


@pytest.fixture(scope="module")
def ranks():
    from deepspeed_tpu.models import llama as jl
    import jax

    cfg = jl.LlamaConfig.tiny(dim=64, n_layers=2, n_heads=4, n_kv_heads=2)
    jp = jax.device_get(jl.init_params(jax.random.PRNGKey(0), cfg))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 33))
    return td.run_ranks("digest", W, {}, {"llama": jp,
                                          "tokens": toks.astype(np.int32)})


def _digest(res, name):
    kinds = [str(k) for k in res[f"{name}/kinds"]]
    return ({k: (int(c), int(b)) for k, c, b in zip(
        kinds, res[f"{name}/counts"], res[f"{name}/bytes"])},
        res[f"{name}/totals"])


def _expected(name):
    """{kind: (count, bytes)} one step of the MLP moves at this rank."""
    sizes = [int(np.prod(a.shape)) for a in td.mlp_params().values()]
    dims = [zero.shard_dim(a.shape, W) for a in td.mlp_params().values()]
    stage = 1 if name == "fp16" else int(name[5])
    wire = 2 if name == "fp16" else 4
    L = len(sizes)
    ar = [3, 4 + 4 * L + 4]
    out = {}
    for n, d in zip(sizes, dims):
        if stage <= 1 or d is None:
            ar[0] += 1
            ar[1] += wire * n
        else:
            c, b = out.get("reduce-scatter", (0, 0))
            out["reduce-scatter"] = (c + 1, b + wire * n)
        if stage >= 1 and d is not None:
            c, b = out.get("all-gather", (0, 0))
            out["all-gather"] = (c + 1, b + 4 * n // W)
    out["all-reduce"] = tuple(ar)
    return out


def test_keys_and_kinds_match_jax():
    want = jdigest.analyze_collectives("", link_gbps=45.0)
    got = tdigest.digest_of({}, link_gbps=45.0)
    assert got == want
    assert tdigest.COLLECTIVE_KINDS == jdigest.COLLECTIVE_KINDS
    summ = {"all_reduce": {"count": 2, "bytes": 8, "time_s": 0.1},
            "all_gather:host": {"count": 1, "bytes": 64, "time_s": 0.1},
            "ppermute": {"count": 3, "bytes": 12, "time_s": 0.0},
            "broadcast": {"count": 1, "bytes": 4, "time_s": 0.0},
            "barrier": {"count": 5, "bytes": 0, "time_s": 0.0}}
    d = tdigest.digest_of(summ, link_gbps=10.0)
    assert set(d) == set(want)
    assert d["per_kind"] == {"all-reduce": {"count": 2, "bytes": 8},
                             "all-gather": {"count": 1, "bytes": 64},
                             "collective-permute": {"count": 3,
                                                    "bytes": 12}}
    assert (d["total_collectives"], d["total_bytes"]) == (6, 84)
    assert d["est_wire_ms"] == round(1e3 * 84 / 10e9, 3)


@pytest.mark.parametrize("name", ["stage0", "stage1", "stage2", "stage3",
                                  "stage2_off", "fp16"])
def test_counts_and_bytes_are_the_stage_expectation(ranks, name):
    want = _expected(name.replace("_off", ""))
    for r in range(W):
        got, totals = _digest(ranks[r], name)
        assert got == want, (r, got, want)
        assert totals[0] == sum(c for c, _ in want.values())
        assert totals[1] == sum(b for _, b in want.values())
        assert totals[3] == 45.0


def test_qgz_and_infinity_digests(ranks):
    got, _ = _digest(ranks[0], "qgz")
    assert got["all-reduce"][0] >= 3 and set(got) <= set(
        tdigest.COLLECTIVE_KINDS)
    res = ranks[0]
    got, totals = _digest(res, "infinity")
    chunks = [int(c) for c in res["infinity/sizes"]]
    assert got["reduce-scatter"] == (len(chunks), sum(4 * W * c
                                                      for c in chunks))
    assert got["all-gather"] == (len(chunks), sum(2 * c for c in chunks))
    assert got["all-reduce"] == (2, 4 + 8)
    assert totals[2] == round(1e3 * totals[1] / 45e9, 3)


@pytest.mark.parametrize("name", NAMES)
def test_digest_leaves_the_trajectory_unchanged(ranks, name):
    for r in range(W):
        plain, probed = ranks[r][f"{name}/losses"]
        np.testing.assert_array_equal(probed, plain)
        assert bool(ranks[r][f"{name}/same_state"])
