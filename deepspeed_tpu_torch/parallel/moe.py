"""Mixture-of-experts on one device (port of ``deepspeed_tpu/parallel/
moe.py``; ref: deepspeed/moe/{layer.py,sharded_moe.py,experts.py}).

The router computes f32 logits, :func:`top_k_gating` assigns each token
its top-k experts with a capacity limit (tokens past an expert's capacity
are dropped; the residual connection carries them) and forms the
load-balance and z losses.  Dispatch and combine are products against the
dense one-hot ``[N, E, C]`` dispatch tensor, the GShard formulation the
JAX package uses: each is one 2-D product (``[N, E*C]``ᵀ ``@ [N, d]`` and
``[N, E*C] @ [E*C, d]``), so ``remat="save_dots_no_batch"`` keeps them as
JAX's ``dots_with_no_batch_dims_saveable`` does.  The experts run as one
product batched over the stacked ``[E, ...]`` leaves (``jax.vmap`` makes
them batched in JAX), which that policy recomputes.

Expert parallelism (a ``mesh`` with an ``expert`` axis, the all-to-all
pair) comes with the distributed slice: a ``mesh`` raises
``NotImplementedError`` naming ROADMAP A9, and so does
:func:`expert_param_specs`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from deepspeed_tpu_torch.config import MoEConfig

EXPERT_AXIS = "expert"


class GateOutput(NamedTuple):
    dispatch: torch.Tensor     # [N, E, C] one-hot (f32)
    combine: torch.Tensor      # [N, E, C] gate-weighted dispatch (f32)
    aux_loss: torch.Tensor     # load-balance loss (scalar)
    z_loss: torch.Tensor       # router logit z-loss (scalar)
    expert_load: torch.Tensor  # [E] fraction of tokens per expert


def capacity(n_tokens: int, n_experts: int, k: int, factor: float,
             min_capacity: int = 4) -> int:
    """ref: sharded_moe.py _capacity — ceil(k*N/E * factor), floored."""
    c = math.ceil(k * n_tokens / n_experts * factor)
    return max(int(c), min_capacity)


def top_k_gating(logits: torch.Tensor, k: int, cap: int,
                 generator: Optional[torch.Generator] = None,
                 noise_std: float = 0.0) -> GateOutput:
    """Top-k router (ref: sharded_moe.py top1gating/top2gating, unified).

    logits: [N, E] f32.  Each choice is a first-occurrence argmax over the
    logits with the earlier choices masked to -inf.  A token's position in
    its expert's buffer is the count of earlier tokens that chose that
    expert in this choice plus every token that chose it in earlier
    choices (integer arithmetic: the positions JAX's f32 cumsum gives for
    N < 2^24); a token at position >= ``cap`` is dropped (its dispatch
    row is zero).  Gate values are renormalised over the k choices with
    ``max(sum, 1e-9)`` when k > 1.  ``noise_std > 0`` adds
    N(0, noise_std^2) noise drawn from ``generator`` to the logits the
    choices read (not to the probabilities), when a generator is given,
    as the JAX gate does with its ``rng``."""
    N, E = logits.shape
    dev = logits.device
    probs = torch.softmax(logits, dim=-1)
    # z-loss (router logit regularizer, ref: sharded_moe gate z_loss)
    z = torch.logsumexp(logits, dim=-1)
    z_loss = torch.mean(z ** 2)

    masked = logits
    if noise_std > 0.0 and generator is not None:
        masked = logits + noise_std * torch.randn(
            logits.shape, generator=generator, device=dev,
            dtype=logits.dtype)

    dispatch = torch.zeros((N, E, cap), dtype=torch.float32, device=dev)
    gates = []            # per choice: (token, expert, slot, kept, gate)
    count = torch.zeros((E,), dtype=torch.long, device=dev)
    gates_sum = torch.zeros((N,), dtype=torch.float32, device=dev)
    tok = torch.arange(N, device=dev)
    first_choice_mask = None
    for _ in range(k):
        sel = torch.argmax(masked, dim=-1)                        # [N]
        onehot = torch.nn.functional.one_hot(sel, E)              # [N, E]
        if first_choice_mask is None:
            first_choice_mask = onehot.float()
        # position of each token in its expert's buffer (token order)
        before = torch.cumsum(onehot, dim=0) - onehot + count[None, :]
        pos = before.gather(1, sel[:, None])[:, 0]                # [N]
        keep = pos < cap
        gate = probs.gather(1, sel[:, None])[:, 0] * keep          # [N]
        slot = torch.clamp(pos, max=cap - 1)
        dispatch[tok, sel, slot] = keep.float()
        gates.append((sel, slot, keep, gate))
        gates_sum = gates_sum + gate
        count = count + onehot.sum(dim=0)
        masked = masked.masked_fill(onehot.bool(), float("-inf"))

    # the combine weights: each kept (token, expert, slot) holds its gate
    # value, renormalised over the chosen experts when k > 1 (ref:
    # top2gating normalizes gate values to sum to 1 across the k choices)
    norm = torch.clamp(gates_sum, min=1e-9) if k > 1 else None
    combine = torch.zeros((N, E, cap), dtype=torch.float32, device=dev)
    for sel, slot, keep, gate in gates:
        w = gate if norm is None else gate / norm
        combine = combine.index_put((tok, sel, slot), w * keep)

    # load-balance loss: E * Σ_e (fraction tokens→e) * (mean router prob→e)
    me = torch.mean(probs, dim=0)
    ce = torch.mean(first_choice_mask, dim=0)
    aux = E * torch.sum(me * ce)
    return GateOutput(dispatch=dispatch, combine=combine, aux_loss=aux,
                      z_loss=z_loss,
                      expert_load=dispatch.sum(-1).sum(0) / max(N, 1))


def _no_mesh(what: str):
    return NotImplementedError(
        f"{what}: expert parallelism over a mesh comes with the distributed "
        "slice (ROADMAP A9)")


@dataclasses.dataclass
class MoELayer:
    """MoE layer on one device (ref: deepspeed/moe/layer.py MoE).

    expert_fn: ``(expert_params, x [E, C, d]) -> y [E, C, d]``, called
        once on the stacked ``[E, ...]`` expert params and the dispatched
        tokens.  A function written for ONE expert with products over the
        trailing two dims (``x @ w``, as the JAX package's per-expert
        functions are) batches over E as ``jax.vmap`` does there.
    mesh: must be None (expert parallelism is ROADMAP A9).
    """

    cfg: MoEConfig
    expert_fn: Callable
    mesh: Optional[Any] = None

    def __post_init__(self):
        if self.mesh is not None:
            raise _no_mesh("MoELayer(mesh=...)")

    def __call__(self, gate_w: torch.Tensor, expert_params: Any,
                 x: torch.Tensor, train: bool = True):
        """x: [B, T, d] -> (y [B, T, d], aux_losses dict).  The router
        runs in f32 (no noise: the JAX layer's ``rng`` reaches a gate whose
        ``noise_std`` is 0); dispatch, experts and combine in x's dtype."""
        cfg = self.cfg
        B, T, d = x.shape
        N = B * T
        xf = x.reshape(N, d)
        logits = xf.float() @ gate_w.float()
        factor = cfg.capacity_factor if train else cfg.eval_capacity_factor
        cap = capacity(N, cfg.num_experts, cfg.top_k, factor,
                       cfg.min_capacity)
        gate = top_k_gating(logits, cfg.top_k, cap)
        E = cfg.num_experts
        # dispatch "nec,nd->ecd" and combine "nec,ecd->nd" as 2-D products
        ein = (gate.dispatch.to(x.dtype).reshape(N, E * cap).T @ xf
               ).reshape(E, cap, d)
        out = self.expert_fn(expert_params, ein)                  # [E, C, d]
        y = gate.combine.to(x.dtype).reshape(N, E * cap) @ out.reshape(
            E * cap, d)
        aux = {
            "moe_aux_loss": gate.aux_loss * cfg.aux_loss_weight,
            "moe_z_loss": gate.z_loss * cfg.z_loss_weight,
            "moe_expert_load": gate.expert_load,
        }
        return y.reshape(B, T, d), aux


def expert_param_specs(specs: Any) -> Any:
    """Prepend the expert axis to per-expert stacked param specs: the
    sharding specs come with the distributed slice."""
    raise _no_mesh("expert_param_specs")
