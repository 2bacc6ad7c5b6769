"""The greedy kernel's split plan and its plain split-and-merge twin
(``greedy_split_plan``, ``greedy_rows_split_reference``: what each block of
a cluster reads and how rank 0 merges the spans) against the JAX Pallas
greedy kernel in interpret mode and ``jnp.argmax``: exact.  The CUDA kernel
itself runs on the card (``tests/test_torch_cuda_kernels.py``).

Rows holding NaN are held to ``jnp.argmax`` alone: the Pallas kernel
compares each element with a NaN max and so answers the padded width for
such a row, where ``jnp.argmax``, ``torch.argmax`` and the port give the
first NaN."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.sampling_pallas import fused_greedy_rows as jax_greedy
from deepspeed_tpu_torch.ops.sampling_cuda import (MAX_SPANS,
                                                   fused_greedy_rows,
                                                   greedy_rows_reference,
                                                   greedy_rows_split_reference,
                                                   greedy_split_plan)

torch.set_num_threads(1)


@pytest.mark.parametrize("V", [1, 7, 1000, 4096, 128256])
@pytest.mark.parametrize("B", [1, 2, 8, 64, 1024])
def test_plan_spans_cover_the_row_once_in_rank_order(B, V):
    want_s = {1: 16, 2: 16, 8: 8, 64: 4, 1024: 1}[B]
    for width, head in ((4, 0), (4, 1), (4, 3), (8, 0), (8, 5), (8, 7)):
        S, edges = greedy_split_plan(B, V, sms=132, width=width, head=head)
        assert S == want_s
        assert len(edges) == S + 1 and edges[0] == 0 and edges[-1] == V
        assert all(a <= b for a, b in zip(edges, edges[1:]))
        covered = np.concatenate([np.arange(lo, hi) for lo, hi
                                  in zip(edges[:-1], edges[1:])])
        np.testing.assert_array_equal(covered, np.arange(V))
        # inner edges sit on the 16-byte vectors after the head, which the
        # ranks share evenly (within one vector of each other)
        h = min(head, V)
        assert all((e - h) % width == 0 for e in edges[1:-1])
        nvec = [(b - a) // width for a, b in zip([h] + edges[1:-1],
                                                  edges[1:-1] + [V])]
        assert max(nvec) - min(nvec) <= 1


def test_plan_spans_follow_the_batch():
    plan = {B: greedy_split_plan(B, 128256)[0]
            for B in (1, 4, 5, 8, 33, 34, 64, 66, 67, 132, 133)}
    # clusters of 16 while B * 16 blocks take at most half of 132 SMs, of 8
    # beyond, then as many as fill the SMs with two blocks each; one block
    # a row once B rows alone fill the card
    assert plan == {1: 16, 4: 16, 5: 8, 8: 8, 33: 8, 34: 7, 64: 4, 66: 4,
                    67: 3, 132: 2, 133: 1}
    # a card of other SMs: 8 rows over 12 SMs take 3 spans each
    assert greedy_split_plan(8, 128256, sms=12)[0] == 3
    assert greedy_split_plan(1, 10, sms=10 ** 6)[0] == MAX_SPANS


def _check(x, sms=132, head=0, pallas=True):
    """The split twin against jnp.argmax (and the Pallas kernel where no
    row holds NaN), torch.argmax and the plain version, exactly."""
    got = greedy_rows_split_reference(torch.from_numpy(x), sms=sms,
                                      head=head).numpy()
    want = np.asarray(jnp.argmax(jnp.asarray(x), axis=-1))
    np.testing.assert_array_equal(got, want)
    if pallas:
        np.testing.assert_array_equal(
            got, np.asarray(jax_greedy(jnp.asarray(x), interpret=True)))
    np.testing.assert_array_equal(
        got, torch.argmax(torch.from_numpy(x), -1).numpy())
    np.testing.assert_array_equal(
        got, greedy_rows_reference(torch.from_numpy(x)).numpy())
    return got


@pytest.mark.parametrize("head", [0, 1, 3])
@pytest.mark.parametrize("B", [1, 8])
def test_twin_ties_straddling_span_edges(B, head):
    """Each row's max sits on both sides of one span edge (and again in a
    later span): the left copy, in the lower rank, wins."""
    V = 4096
    x = np.random.default_rng(B + head).standard_normal(
        (B, V), dtype=np.float32)
    S, edges = greedy_split_plan(B, V, head=head)
    pick = [edges[1 + b % (S - 1)] for b in range(B)]
    for b, e in enumerate(pick):
        x[b, [e - 1, e, V - 1]] = 9.0
    got = _check(x, head=head)
    np.testing.assert_array_equal(got, np.asarray(pick) - 1)


def test_twin_nan_in_a_later_span_than_the_max():
    V = 4096
    x = np.random.default_rng(1).standard_normal((4, V), dtype=np.float32)
    _, edges = greedy_split_plan(4, V)
    x[:, 3] = 50.0                         # the max, in span 0
    x[0, edges[9] + 2] = np.nan            # NaN in span 9 wins
    x[1, [edges[15], edges[3]]] = np.nan   # the first NaN wins
    x[2] = np.nan                          # all NaN: 0
    got = _check(x, pallas=False)
    np.testing.assert_array_equal(got, [edges[9] + 2, edges[3], 0, 3])


@pytest.mark.parametrize("sms,spans", [(132, 16), (1, 1), (8, 5)])
def test_twin_all_minus_inf_row(sms, spans):
    x = np.random.default_rng(2).standard_normal((3, 1024), dtype=np.float32)
    x[0] = -np.inf
    x[2, :1000] = -np.inf                  # the max only in the last span
    assert greedy_split_plan(3, 1024, sms=sms)[0] == spans
    got = _check(x, sms=sms)
    assert got[0] == 0 and got[2] >= 1000


@pytest.mark.parametrize("V", [1, 7, 40, 50])
def test_twin_empty_spans(V):
    """V below 16 spans of one 16-byte vector each: most spans are empty
    and give the pair (-inf, V), which never wins."""
    rng = np.random.default_rng(V)
    x = rng.standard_normal((4, V), dtype=np.float32)
    S, edges = greedy_split_plan(4, V)
    assert S == 16 and sum(b == a for a, b in zip(edges, edges[1:])) > 0
    x[1, :-1] = -np.inf                    # the max in the last span
    x[2, :] = 3.0                          # all tied: index 0
    got = _check(x)
    assert got[1] == V - 1 and got[2] == 0


@pytest.mark.parametrize("sms,spans,head", [(5, 2, 0), (8, 3, 2),
                                            (160, 16, 1), (160, 16, 3)])
def test_twin_random_rows_any_split(sms, spans, head):
    """Five rows on cards of other SM counts, hence other splits."""
    x = np.random.default_rng(spans * 10 + head).standard_normal(
        (5, 1000), dtype=np.float32)
    x[:, ::7] = np.round(x[:, ::7])        # many ties
    x[3, [10, 500, 999]] = 8.0
    assert greedy_split_plan(5, 1000, sms=sms)[0] == spans
    _check(x, sms=sms, head=head)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_wrapper_takes_half_types(dtype):
    """bf16 and fp16 logits: the indices JAX gives on the same values cast
    to f32 (the cast is exact), from the wrapper and the split twin."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (8, 2048), dtype=np.float32)).to(dtype)
    x[0, [100, 1500]] = 6.0
    x[5, :] = float("-inf")
    f32 = x.float().numpy()
    want = np.asarray(jax_greedy(jnp.asarray(f32), interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(jnp.argmax(jnp.asarray(f32), axis=-1)))
    np.testing.assert_array_equal(fused_greedy_rows(x).numpy(), want)
    np.testing.assert_array_equal(greedy_rows_split_reference(x).numpy(),
                                  want)
    assert fused_greedy_rows(x)[0] == 100


def test_wrapper_takes_the_last_position_of_a_strided_batch():
    """``logits[:, -1]`` of a [B, T, V] tensor, as the decode step hands it
    over: the same indices as JAX on a contiguous copy."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, 3, 1000), dtype=np.float32))
    last = x[:, -1]
    assert not last.is_contiguous()
    want = np.asarray(jax_greedy(jnp.asarray(last.numpy().copy()),
                                 interpret=True))
    np.testing.assert_array_equal(fused_greedy_rows(last).numpy(), want)
    np.testing.assert_array_equal(
        greedy_rows_split_reference(last).numpy(), want)
