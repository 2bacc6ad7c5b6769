"""Pipeline parallelism over the ``pipe`` axis (port of ``deepspeed_tpu/
parallel/pipeline.py``; ref: deepspeed/runtime/pipe/{module,engine,
schedule}.py).

The layer stack is already a stacked ``[L, ...]`` tree, so partitioning is
a split of the stack dim over ``pipe`` (:func:`stage_spec`): each rank
holds ``L / S`` layers.  :func:`pipelined_scan` runs the JAX tick schedule,
M + S - 1 ticks for M microbatches over S stages: each tick every stage
hands its last output to the next by :func:`~deepspeed_tpu_torch.comm.
ppermute`, runs its sub-stack on what it received (stage 0 on microbatch
t) and the last stage keeps its outputs, which are then broadcast so the
head and the loss run on every rank.  A stage computes only the ticks that
carry a real microbatch (the JAX scan computes the bubble too and discards
it).

The backward is the reverse pipeline, which ``jax.grad`` derives from
``ppermute``'s transpose.  Autograd cannot be left to order point-to-point
exchanges across ranks, so the backward is the same tick schedule run in
reverse by hand: each tick every stage receives its successor's input
cotangent, back-propagates its sub-stack for that microbatch and hands the
result on.  The input's cotangent is summed over the axis (every rank
holds the replicated input; only stage 0 reads it), and the output's is
taken on the last stage (every rank computes the same loss), so the
embedding and head grads are whole on every stage and the stage's own
layers get their grads locally.

Remat of the stage body: ``"none"`` keeps each microbatch's graph from
the forward (GPipe's activation memory); ``"full"`` keeps only the stage
inputs and recomputes each microbatch's stage forward in the backward;
any other policy of :mod:`deepspeed_tpu_torch.remat` wraps the stage body
(``checkpoint_block``), as the JAX package wraps it in ``jax.checkpoint``
with that policy.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch._tree import tree_leaves, tree_unflatten_like
from deepspeed_tpu_torch.topology import Spec

PIPE_AXIS = "pipe"


def stage_spec(base) -> Spec:
    """Prepend the pipe axis to a stacked-layer leaf spec: the ``[L, ...]``
    stack dim splits over ``pipe``."""
    rest = tuple(base) if base is not None else ()
    if rest and rest[0] == PIPE_AXIS:
        return rest
    if rest:
        return (PIPE_AXIS,) + rest[1:]
    return (PIPE_AXIS,)


def uniform_partition(n_layers: int, n_stages: int) -> list:
    """Layer -> stage assignment (ref: PipelineModule partition_method
    "uniform" / "parameters"): contiguous equal slabs."""
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible into {n_stages} "
                         "stages")
    return [n_layers // n_stages] * n_stages


class PipelineSchedule:
    """Named schedules for config parity (ref: runtime/pipe/schedule.py).
    Both run the same tick schedule: M + S - 1 ticks for M microbatches
    over S stages, bubble fraction (S - 1) / (M + S - 1)."""

    GPIPE = "gpipe"
    ONE_F_ONE_B = "1f1b"

    @staticmethod
    def n_ticks(n_micro: int, n_stages: int) -> int:
        return n_micro + n_stages - 1

    @staticmethod
    def bubble_fraction(n_micro: int, n_stages: int) -> float:
        return (n_stages - 1) / (n_micro + n_stages - 1)


def _stack_len(stacked: Any) -> int:
    return int(tree_leaves(stacked)[0].shape[0])


def _stage_body(block_fn: Callable, stacked: Any, x):
    """This stage's layers in order: ``x = block_fn(x, layer l)``."""
    for l in range(_stack_len(stacked)):
        layer = tree_unflatten_like(stacked, [t[l] for t in
                                              tree_leaves(stacked)])
        x = block_fn(x, layer)
    return x


def _handoff(x: torch.Tensor, pairs: List[tuple]) -> torch.Tensor:
    """One tick's exchange: each ``(s, s + 1)`` pair moves s's tensor."""
    return comm.ppermute(x, PIPE_AXIS, pairs)


class _Pipelined(torch.autograd.Function):
    """The tick schedule forward, and in reverse for the backward."""

    @staticmethod
    def forward(ctx, plan, x, *leaves):
        block_fn, skeleton, M, S, sid, remat = plan
        xs = list(x.chunk(M))
        mb_shape = xs[0].shape
        keep_graph = remat != "full"
        params = tree_unflatten_like(skeleton, [
            l.detach().requires_grad_(l.requires_grad) for l in leaves])
        body = _stage_body
        if remat not in ("none", "full"):
            from deepspeed_tpu_torch.remat import checkpoint_block

            body = checkpoint_block(_stage_body, remat)
        inputs, graphs, outs = [None] * M, [None] * M, [None] * M
        state = x.new_zeros(mb_shape)
        for t in range(M + S - 1):
            pairs = [(s, s + 1) for s in range(S - 1) if 0 <= t - 1 - s < M]
            recv = _handoff(state, pairs)
            m = t - sid
            if not 0 <= m < M:
                continue
            inp = (xs[m] if sid == 0 else recv).detach()
            if keep_graph:
                inp.requires_grad_(True)
                with torch.enable_grad():
                    out = body(block_fn, params, inp)
                graphs[m] = out
            else:
                with torch.no_grad():
                    out = body(block_fn, params, inp)
            inputs[m] = inp
            state = out.detach()
            if sid == S - 1:
                outs[m] = state
        y = torch.cat(outs) if sid == S - 1 else x.new_empty(
            (x.shape[0],) + tuple(state.shape[1:]))
        y = comm.broadcast(y, PIPE_AXIS, src=S - 1)
        ctx.plan, ctx.params = plan, params
        ctx.inputs, ctx.graphs = inputs, graphs
        ctx.x_shape, ctx.mb_shape = x.shape, mb_shape
        return y

    @staticmethod
    def backward(ctx, dy):
        block_fn, skeleton, M, S, sid, remat = ctx.plan
        params = ctx.params
        plist = tree_leaves(params)
        wanted = [p for p in plist if p.requires_grad]
        grads = [torch.zeros_like(p) if p.requires_grad else None
                 for p in plist]
        dys = list(dy.chunk(M)) if sid == S - 1 else None
        dxs = [None] * M
        g_state = dy.new_zeros(ctx.mb_shape)
        for t in reversed(range(M + S - 1)):
            # stage s + 1 hands back the input cotangent of microbatch
            # t - s, which it finished at the previous (later) tick
            pairs = [(s + 1, s) for s in range(S - 1) if 0 <= t - s < M]
            recv = _handoff(g_state, pairs)
            m = t - sid
            if not 0 <= m < M:
                continue
            g_out = dys[m] if sid == S - 1 else recv
            inp = ctx.inputs[m]
            if remat == "full":
                inp = inp.detach().requires_grad_(True)
                with torch.enable_grad():
                    out = _stage_body(block_fn, params, inp)
            else:
                out = ctx.graphs[m]
                ctx.graphs[m] = None
            res = torch.autograd.grad(out, [inp] + wanted, g_out,
                                      allow_unused=True)
            del out
            g_in, pg = res[0], iter(res[1:])
            for i, p in enumerate(plist):
                if p.requires_grad:
                    g = next(pg)
                    if g is not None:
                        grads[i].add_(g)
            g_state = g_in
            if sid == 0:
                dxs[m] = g_in
            ctx.inputs[m] = None
        if sid == 0:
            dx = torch.cat(dxs)
        else:
            dx = dy.new_zeros(ctx.x_shape)
        # the input is replicated over the axis and read by stage 0 only
        dx = comm.all_reduce(dx, PIPE_AXIS)
        ctx.params = ctx.inputs = ctx.graphs = None
        return (None, dx, *grads)


def pipelined_scan(block_fn: Callable, stacked_params: Any, x: torch.Tensor,
                   n_micro: int, mesh=None, remat="none") -> torch.Tensor:
    """The pipelined equivalent of ``for l: x = block_fn(x, layer l)``.

    block_fn: ``(act, layer_params) -> act``.  stacked_params: this stage's
    ``[L / S, ...]`` block of the stacked layer tree (:func:`stage_spec`).
    x: [B, ...] activations, replicated over the axis; B divisible by
    ``n_micro``.  remat: ``"none"`` / False, ``"full"`` / True, or a
    policy name of :mod:`deepspeed_tpu_torch.remat`.  Returns [B, ...]
    after all L layers, on every rank of the axis."""
    from deepspeed_tpu_torch.topology import current_mesh

    if remat is True:
        remat = "full"
    elif remat is False or remat is None:
        remat = "none"
    ms = mesh if mesh is not None else current_mesh()
    S = 1 if ms is None else ms.size(PIPE_AXIS)
    if S <= 1:
        return _stage_body(block_fn, stacked_params, x)
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by n_micro {n_micro}")
    leaves = tree_leaves(stacked_params)
    skeleton = tree_unflatten_like(stacked_params, [0] * len(leaves))
    plan = (block_fn, skeleton, int(n_micro), S, ms.rank_in(PIPE_AXIS),
            remat)
    return _Pipelined.apply(plan, x, *leaves)
