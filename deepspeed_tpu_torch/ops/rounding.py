"""Stochastic rounding f32 -> bf16 (port of ``deepspeed_tpu/ops/
rounding.py``; ref behaviour: deepspeed's bf16_optimizer keeps f32 masters
because round-to-nearest bf16 updates lose small deltas, and stochastic
rounding is the mitigation when even the masters are kept in bf16).

Rule: with x's f32 bits u, add a uniform 16-bit integer r to the low half
and keep the high 16 bits, so x rounds up with probability (low bits) /
2^16 and E[round(x)] = x.  Non-finite values take the plain cast.  The JAX
package computes it in plain ``jnp`` (no Pallas kernel: XLA fuses it into
the update around it), and so does the port, in plain PyTorch on both
devices.  The bits are read through an ``int32`` view and added in
``int64``, since PyTorch's ``uint32`` arithmetic is partial.

The random bits come from a ``torch.Generator`` on x's device.  JAX's
threefry bits cannot be reproduced (ROADMAP C-w1), and PyTorch's CPU and
CUDA generators give different streams for one seed; :func:`round_with_bits`
takes the bits as an argument, so the two devices can be held to each
other on the same bits.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from deepspeed_tpu_torch._tree import tree_leaves, tree_unflatten_like

_LOW = 1 << 16


def round_with_bits(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` -> bf16, rounded up where ``bits`` (integers in [0, 2^16)
    of x's shape) plus x's low 16 bits carry into the high half."""
    x = x.float()
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    up = (u + bits.to(torch.int64)) & 0xFFFF0000
    # back to the signed 32-bit pattern (finite x never carries past 2^32)
    y = torch.where(up >= 1 << 31, up - (1 << 32), up).to(
        torch.int32).view(torch.float32)
    return torch.where(torch.isfinite(x), y, x).to(torch.bfloat16)


def random_bits(shape, generator: Optional[torch.Generator] = None,
                device=None) -> torch.Tensor:
    """Uniform integers in [0, 2^16) of ``shape`` (int64) from
    ``generator`` on ``device``."""
    return torch.randint(0, _LOW, tuple(shape), generator=generator,
                         device=device, dtype=torch.int64)


def stochastic_round_bf16(x: torch.Tensor,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """Round f32 ``x`` (any shape) to bf16 stochastically (unbiased), with
    bits drawn from ``generator`` (on x's device; None: the default
    generator of that device)."""
    return round_with_bits(x, random_bits(x.shape, generator, x.device))


def stochastic_round_tree(tree: Any,
                          generator: Optional[torch.Generator] = None
                          ) -> Any:
    """Every f32 leaf of ``tree`` stochastically cast to bf16; other leaves
    as they are.  Each leaf draws from its own child generator, seeded
    from the parent ``generator`` (one seed per leaf, f32 or not, as the
    JAX version splits one key per leaf)."""
    leaves = tree_leaves(tree)
    dev = generator.device if generator is not None else torch.device("cpu")
    seeds = torch.randint(0, 2 ** 62, (len(leaves),), generator=generator,
                          device=dev, dtype=torch.int64).tolist()
    out = []
    for leaf, seed in zip(leaves, seeds):
        if leaf.dtype != torch.float32:
            out.append(leaf)
            continue
        child = torch.Generator(device=leaf.device).manual_seed(seed)
        out.append(stochastic_round_bf16(leaf, child))
    return tree_unflatten_like(tree, out)
