"""Megatron-style tensor (intra-layer model) parallelism over the ``model``
axis (port of ``deepspeed_tpu/parallel/tensor_parallel.py``; ref: the
Megatron mpu layers DeepSpeed wires in through ``mpu``,
deepspeed/utils/groups.py ``_get_model_parallel_group``).

The spec builders return the port's placement tuples
(:data:`~deepspeed_tpu_torch.topology.Spec`): a column-parallel weight
splits its output features over ``model``, a row-parallel weight its
input features, and the embedding its feature dim.  Under JAX's GSPMD
these only place data and XLA inserts the collectives; here each rank
holds its block (:func:`~deepspeed_tpu_torch.zero.local_shard`) and the
layer forms below perform what XLA inserts: the input of a column-parallel
product is :func:`~deepspeed_tpu_torch.comm.copy_to` the axis (its
backward all-reduces the partial input grads), a row-parallel product's
partial sums are :func:`~deepspeed_tpu_torch.comm.reduce_from` it, and a
feature-sharded activation is gathered where the next op needs it whole.
Every rank of the axis computes the same loss, so these are Megatron's
four mappings, not JAX's transposes.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.topology import MeshSpec, Spec, current_mesh

MODEL_AXIS = "model"


# ------------------------------------------------------------------ specs
def column_parallel(ndim: int = 2, axis: str = MODEL_AXIS,
                    stacked: bool = False) -> Spec:
    """Spec of a weight whose OUTPUT features split over ``axis``;
    ``stacked`` prepends the layer-stack dim."""
    dims: list = [None] * ndim
    dims[-1] = axis
    return tuple([None] + dims if stacked else dims)


def row_parallel(ndim: int = 2, axis: str = MODEL_AXIS,
                 stacked: bool = False) -> Spec:
    """Spec of a weight whose INPUT features split over ``axis`` (its
    product gives partial sums, reduced by :func:`row_parallel_linear`)."""
    dims: list = [None] * ndim
    dims[-2] = axis
    return tuple([None] + dims if stacked else dims)


def vocab_parallel_embedding(axis: str = MODEL_AXIS) -> Spec:
    """The embedding table sharded on its feature dim (the JAX package's
    choice: the token lookup stays local and its output is gathered)."""
    return (None, axis)


# ------------------------------------------------------ activation forms
def gather_output(x: torch.Tensor, mesh: Optional[MeshSpec] = None,
                  dim: int = -1, axis: str = MODEL_AXIS) -> torch.Tensor:
    """The feature-sharded ``x`` gathered whole along ``dim`` (the
    ``gather_output=True`` flag of ColumnParallelLinear)."""
    return comm.gather_from(x, axis, dim)


def scatter_activation(x: torch.Tensor, mesh: Optional[MeshSpec] = None,
                       dim: int = -1, axis: str = MODEL_AXIS
                       ) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (RowParallelLinear's
    ``input_is_already_split`` path)."""
    return comm.scatter_to(x, axis, dim)


def column_parallel_linear(x, w, b=None, axis: str = MODEL_AXIS):
    """y = x @ w (+ b) with ``w`` and ``b`` this rank's output columns:
    ``y`` is feature-sharded."""
    y = comm.copy_to(x, axis) @ w
    return y if b is None else y + b


def row_parallel_linear(x, w, b=None, axis: str = MODEL_AXIS):
    """y = x @ w with ``x`` and ``w`` split on the contracted features:
    the partial sums reduced over ``axis``, the whole bias added once
    after the reduction."""
    y = comm.reduce_from(x @ w, axis)
    return y if b is None else y + b


class _VocabParallelNLL(torch.autograd.Function):
    """Megatron's vocab-parallel cross entropy: the NLL summed over rows
    of logits whose vocabulary is split over the axis, without gathering
    them; the max, the sum of exponentials and the target's logit are
    all-reduced ([N] vectors).  Every rank of the axis holds the same
    sum, so the backward is each rank's softmax block minus its block of
    the one-hot targets."""

    @staticmethod
    def forward(ctx, logits, targets, mask, axis):
        V = logits.shape[-1]
        lo = comm.rank_in(axis) * V
        m = comm.all_reduce_(logits.amax(-1), axis, comm.ReduceOp.MAX)
        e = torch.exp(logits - m[:, None])
        s = comm.all_reduce_(e.sum(-1), axis)
        local = targets.long() - lo
        hit = (local >= 0) & (local < V)
        picked = logits.gather(-1, local.clamp(0, V - 1)[:, None])[:, 0]
        t = comm.all_reduce_(torch.where(hit, picked,
                                         torch.zeros_like(picked)), axis)
        nll = m + torch.log(s) - t
        ctx.save_for_backward(e, s, local, hit, mask)
        return (nll * mask).sum()

    @staticmethod
    def backward(ctx, g):
        e, s, local, hit, mask = ctx.saved_tensors
        d = e / s[:, None]
        d.scatter_add_(-1, local.clamp(0, e.shape[-1] - 1)[:, None],
                       -hit.to(d.dtype)[:, None])
        return d * (g * mask)[:, None], None, None, None


def vocab_parallel_nll_sum(logits, targets, mask=None,
                           axis: str = MODEL_AXIS):
    """(sum of the (masked) NLL, count of counted rows) of f32 ``logits``
    [..., V / tp] holding this rank's vocabulary block against ``targets``
    [...]: :func:`~deepspeed_tpu_torch.ops.losses.lm_loss_sum` without
    the whole logits on any rank."""
    logits = logits.reshape(-1, logits.shape[-1]).float()
    targets = targets.reshape(-1)
    m = (torch.ones(targets.shape, dtype=torch.float32,
                    device=logits.device) if mask is None
         else mask.reshape(-1).float())
    return _VocabParallelNLL.apply(logits, targets, m, axis), m.sum()


def tp_degree(mesh: Optional[MeshSpec] = None) -> int:
    ms = mesh if mesh is not None else current_mesh()
    return 1 if ms is None else ms.size(MODEL_AXIS)


def head_sharding_ok(n_heads: int, mesh: Optional[MeshSpec] = None) -> bool:
    """Tensor parallelism needs the head count to divide over the axis."""
    t = tp_degree(mesh)
    return t <= 1 or n_heads % t == 0


# ------------------------------------------- shape-driven forms (models)
def col_input(h: torch.Tensor, w, full_out: int,
              axis: str = MODEL_AXIS) -> torch.Tensor:
    """``h`` ready for a product with ``w``: copied to the axis when ``w``
    holds only this rank's output columns (its last dim short of
    ``full_out``), as it is otherwise.  The models decide from the leaf's
    shape, so an unsharded tree runs unchanged beside a sharded one."""
    return comm.copy_to(h, axis) if w.shape[-1] != full_out else h


def row_output(y: torch.Tensor, w, full_in: int,
               axis: str = MODEL_AXIS) -> torch.Tensor:
    """A product's partial sums reduced over the axis when ``w`` holds
    only this rank's input rows (its second-to-last dim short of
    ``full_in``), ``y`` as it is otherwise."""
    return comm.reduce_from(y, axis) if w.shape[-2] != full_in else y


def whole_features(table: torch.Tensor, full: int,
                   axis: str = MODEL_AXIS) -> torch.Tensor:
    """``table`` [..., full] whole: gathered over the axis when it holds
    only this rank's block of its last dim (the backward keeps this rank's
    slice of the grad), as it is otherwise."""
    return (comm.gather_from(table, axis, -1) if table.shape[-1] != full
            else table)


def tied_head_logits(h: torch.Tensor, table: torch.Tensor,
                     axis: str = MODEL_AXIS) -> torch.Tensor:
    """f32 logits ``h @ table.T`` [..., V] of the hidden state ``h`` [...,
    d] through a tied embedding ``table`` [V, d], which may hold only this
    rank's block of the features [V, d / tp].  Every rank ends with the
    whole vocabulary, by whichever of two ways moves fewer bytes: the
    block is gathered whole (V * d table elements; a training batch, a
    lot, a long prefill), or the products over this rank's features are
    partial sums of the logits, all-reduced (twice N * V f32 values; a
    decode step's few rows)."""
    from deepspeed_tpu_torch.ops.losses import f32_matmul

    d = h.shape[-1]
    dt = torch.promote_types(h.dtype, table.dtype)
    rows = h.numel() // d
    if table.shape[-1] != d and 8 * rows < d * table.element_size():
        return comm.reduce_from(f32_matmul(
            comm.scatter_to(h.to(dt), axis, -1), table.to(dt).T), axis)
    return f32_matmul(h.to(dt), whole_features(table, d, axis).to(dt).T)
