"""Block-sparse attention (port of ``deepspeed_tpu/ops/sparse_attention.py``;
ref: deepspeed/ops/sparse_attention/).

The reference ships Triton block-sparse matmul/softmax kernels driven by a
``SparsityConfig`` hierarchy (sparsity_config.py: Dense, Fixed, Variable,
BigBird, BSLongformer, LocalSlidingWindow) and a ``SparseSelfAttention``
module (sparse_self_attention.py) that composes them.

The layouts are the JAX package's numpy code as it is (the random blocks
of ``Variable`` and ``BigBird`` draw from ``np.random.RandomState(seed)``),
so both packages build the same static per-head boolean matrix over
[num_blocks, num_blocks].  The layout becomes a gather plan: for every
query block-row the (padded, fixed-size) list of its active key
block-columns.  :func:`sparse_attention` gathers exactly those K/V blocks
and runs masked attention over them in plain PyTorch, as the JAX package
does in XLA outside any Pallas kernel; gradients come from autograd.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

NEG_INF = -1e30


# --------------------------------------------------------------------------
# Sparsity configs (ref: deepspeed/ops/sparse_attention/sparsity_config.py)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class SparsityConfig:
    """Base config: per-head block layout factory.

    ``make_layout(seq_len)`` returns a numpy bool array
    [num_heads, nb, nb] where nb = seq_len // block; entry [h, i, j] says
    query block i of head h attends to key block j.
    """

    num_heads: int = 1
    block: int = 64
    different_layout_per_head: bool = False

    def _nb(self, seq_len: int) -> int:
        if seq_len % self.block != 0:
            raise ValueError(
                f"seq_len {seq_len} not divisible by block {self.block}")
        return seq_len // self.block

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError

    def _expand_heads(self, one: np.ndarray) -> np.ndarray:
        return np.broadcast_to(one[None], (self.num_heads,) + one.shape).copy()


@dataclasses.dataclass
class DenseSparsityConfig(SparsityConfig):
    """All blocks active (ref: DenseSparsityConfig) — debugging/parity."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        nb = self._nb(seq_len)
        return self._expand_heads(np.ones((nb, nb), bool))


@dataclasses.dataclass
class FixedSparsityConfig(SparsityConfig):
    """ref: FixedSparsityConfig — local blocks within windows of
    ``num_local_blocks``, plus ``num_global_blocks`` summary columns taken
    from the tail of each preceding window (and, non-causally, broadcast
    rows)."""

    num_local_blocks: int = 4
    num_global_blocks: int = 1
    attention: str = "bidirectional"  # "unidirectional" (causal) | "bidirectional"
    horizontal_global_attention: bool = False

    def make_layout(self, seq_len: int) -> np.ndarray:
        nb = self._nb(seq_len)
        L, G = self.num_local_blocks, self.num_global_blocks
        causal = self.attention == "unidirectional"
        lay = np.zeros((nb, nb), bool)
        for i in range(nb):
            w = (i // L) * L                      # window start
            # local window
            for j in range(w, min(w + L, nb)):
                lay[i, j] = True
            # global columns: last G blocks of every previous window
            for ws in range(0, w, L):
                for j in range(max(ws, ws + L - G), min(ws + L, nb)):
                    lay[i, j] = True
        if self.horizontal_global_attention and not causal:
            for ws in range(0, nb, L):
                for i in range(max(ws, ws + L - G), min(ws + L, nb)):
                    lay[i, :] = True
        if causal:
            tril = np.tril(np.ones((nb, nb), bool))
            lay &= tril
        return self._expand_heads(lay)


@dataclasses.dataclass
class VariableSparsityConfig(SparsityConfig):
    """ref: VariableSparsityConfig — custom local window sizes +
    explicit global block indices + random blocks."""

    num_random_blocks: int = 0
    local_window_blocks: Tuple[int, ...] = (4,)
    global_block_indices: Tuple[int, ...] = (0,)
    attention: str = "bidirectional"
    horizontal_global_attention: bool = False
    seed: int = 0

    def make_layout(self, seq_len: int) -> np.ndarray:
        nb = self._nb(seq_len)
        causal = self.attention == "unidirectional"
        lay = np.zeros((nb, nb), bool)
        # local windows: consecutive windows take sizes from
        # local_window_blocks; the last size repeats.
        start = 0
        wi = 0
        while start < nb:
            size = self.local_window_blocks[min(wi, len(self.local_window_blocks) - 1)]
            end = min(start + size, nb)
            lay[start:end, start:end] = True
            start = end
            wi += 1
        for g in self.global_block_indices:
            if g < nb:
                lay[:, g] = True  # vertical global
                if self.horizontal_global_attention and not causal:
                    lay[g, :] = True
        if self.num_random_blocks:
            rng = np.random.RandomState(self.seed)
            for i in range(nb):
                hi = (i + 1) if causal else nb
                if hi > 0:
                    cols = rng.randint(0, hi, size=self.num_random_blocks)
                    lay[i, cols] = True
        if causal:
            lay &= np.tril(np.ones((nb, nb), bool))
        return self._expand_heads(lay)


@dataclasses.dataclass
class BigBirdSparsityConfig(SparsityConfig):
    """ref: BigBirdSparsityConfig — random + sliding-window + global."""

    num_random_blocks: int = 1
    num_sliding_window_blocks: int = 3
    num_global_blocks: int = 1
    attention: str = "bidirectional"
    seed: int = 0

    def make_layout(self, seq_len: int) -> np.ndarray:
        nb = self._nb(seq_len)
        causal = self.attention == "unidirectional"
        rng = np.random.RandomState(self.seed)
        heads = []
        n_lay = self.num_heads if self.different_layout_per_head else 1
        for _ in range(n_lay):
            lay = np.zeros((nb, nb), bool)
            w = self.num_sliding_window_blocks // 2
            for i in range(nb):
                lo, hi = max(0, i - w), min(nb, i + w + 1)
                lay[i, lo:hi] = True
            g = min(self.num_global_blocks, nb)
            lay[:, :g] = True
            if not causal:
                lay[:g, :] = True
            for i in range(nb):
                hi = (i + 1) if causal else nb
                if hi > 0:
                    cols = rng.randint(0, hi, size=self.num_random_blocks)
                    lay[i, cols] = True
            if causal:
                lay &= np.tril(np.ones((nb, nb), bool))
            heads.append(lay)
        if n_lay == 1:
            return self._expand_heads(heads[0])
        return np.stack(heads)


@dataclasses.dataclass
class BSLongformerSparsityConfig(SparsityConfig):
    """ref: BSLongformerSparsityConfig — sliding window + chosen global
    block indices (symmetric attention to/from globals)."""

    num_sliding_window_blocks: int = 3
    global_block_indices: Tuple[int, ...] = (0,)
    global_block_end_indices: Optional[Tuple[int, ...]] = None
    attention: str = "bidirectional"

    def make_layout(self, seq_len: int) -> np.ndarray:
        nb = self._nb(seq_len)
        causal = self.attention == "unidirectional"
        lay = np.zeros((nb, nb), bool)
        w = self.num_sliding_window_blocks // 2
        for i in range(nb):
            lo, hi = max(0, i - w), min(nb, i + w + 1)
            lay[i, lo:hi] = True
        if self.global_block_end_indices is None:
            spans = [(g, g + 1) for g in self.global_block_indices]
        else:
            spans = list(zip(self.global_block_indices,
                             self.global_block_end_indices))
        for lo, hi in spans:
            lo, hi = max(0, lo), min(nb, hi)
            lay[:, lo:hi] = True
            if not causal:
                lay[lo:hi, :] = True
        if causal:
            lay &= np.tril(np.ones((nb, nb), bool))
        return self._expand_heads(lay)


@dataclasses.dataclass
class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """ref: LocalSlidingWindowSparsityConfig — pure sliding window."""

    num_sliding_window_blocks: int = 3
    attention: str = "unidirectional"

    def make_layout(self, seq_len: int) -> np.ndarray:
        nb = self._nb(seq_len)
        causal = self.attention == "unidirectional"
        lay = np.zeros((nb, nb), bool)
        w = self.num_sliding_window_blocks // 2 if not causal else \
            self.num_sliding_window_blocks - 1
        for i in range(nb):
            lo = max(0, i - w)
            hi = (i + 1) if causal else min(nb, i + w + 1)
            lay[i, lo:hi] = True
        return self._expand_heads(lay)


# --------------------------------------------------------------------------
# Gather plan
# --------------------------------------------------------------------------
def _gather_plan(layout: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """layout [H, nb, nb] bool → (idx [H, nb, A] int32, mask [H, nb, A] bool)
    where A = max active blocks over all rows/heads; inactive slots point
    at block 0 and are masked out of the softmax."""
    H, nb, _ = layout.shape
    counts = layout.sum(-1)
    if (counts == 0).any():
        raise ValueError("sparsity layout has a query block-row with no "
                         "active key blocks")
    A = int(counts.max())
    idx = np.zeros((H, nb, A), np.int32)
    mask = np.zeros((H, nb, A), bool)
    for h in range(H):
        for i in range(nb):
            cols = np.nonzero(layout[h, i])[0]
            idx[h, i, :len(cols)] = cols
            mask[h, i, :len(cols)] = True
    return idx, mask


_MODE_REGISTRY = {
    "dense": DenseSparsityConfig,
    "fixed": FixedSparsityConfig,
    "variable": VariableSparsityConfig,
    "bigbird": BigBirdSparsityConfig,
    "bslongformer": BSLongformerSparsityConfig,
    "local_sliding_window": LocalSlidingWindowSparsityConfig,
}


def sparsity_config_from_dict(d, num_heads: int, **defaults) -> SparsityConfig:
    """``{"mode": "fixed"|"bigbird"|..., ...}`` → SparsityConfig (ref:
    the ``sparse_attention`` JSON block of deepspeed/runtime/config.py,
    whose ``mode`` picks the sparsity_config class).

    ``defaults`` are soft: applied only when the chosen class has the
    field and the dict didn't set it (e.g. a causal-LM caller defaults
    ``attention="unidirectional"`` — meaningless for dense)."""
    d = dict(d or {})
    d.pop("num_heads", None)  # the caller's model owns the head count
    mode = str(d.pop("mode", "fixed")).lower()
    if mode not in _MODE_REGISTRY:
        raise ValueError(f"unknown sparse_attention mode {mode!r}; "
                         f"one of {sorted(_MODE_REGISTRY)}")
    cls = _MODE_REGISTRY[mode]
    known = {f.name for f in dataclasses.fields(cls)}
    for key, val in defaults.items():
        if key in known:
            d.setdefault(key, val)
    unknown = set(d) - known
    if unknown:
        raise ValueError(
            f"sparse_attention mode {mode!r} does not accept {sorted(unknown)}")
    for tup in ("local_window_blocks", "global_block_indices",
                "global_block_end_indices"):
        if tup in d and d[tup] is not None:
            d[tup] = tuple(d[tup])
    return cls(num_heads=num_heads, **d)


def sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     layout: np.ndarray, block: int,
                     causal: bool = False,
                     scale: Optional[float] = None,
                     attn_mask: Optional[torch.Tensor] = None,
                     segment_ids: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Block-sparse attention over a static layout.

    q/k/v: [B, H, S, D]; layout: numpy bool [H, S//block, S//block].
    Equivalent to softmax(q k^T scale + blockmask) v over the active
    blocks only (gathered K/V), the reference's MatMul(sdd) -> Softmax ->
    MatMul(dsd) pipeline.  Scores and the softmax are f32 (the JAX
    einsum's ``preferred_element_type``), the probabilities are cast to
    q's dtype before the value product, and a query row whose gathered
    keys are all masked gives zeros.

    Memory: the gather materialises kg/vg of shape [B, H, nb, A, block, D]:
    each K/V block once per attending query block-row (K in f32 for the
    scores), so peak activation memory can exceed dense attention's.
    """
    B, H, S, D = q.shape
    nb = S // block
    if layout.shape != (H, nb, nb):
        raise ValueError(f"layout shape {layout.shape} != {(H, nb, nb)}")
    scale = scale if scale is not None else 1.0 / np.sqrt(D)
    idx_np, amask_np = _gather_plan(layout)
    A = idx_np.shape[-1]
    dev = q.device
    idx = torch.from_numpy(idx_np).to(dev).long()          # [H, nb, A]
    amask = torch.from_numpy(amask_np).to(dev)             # [H, nb, A]
    heads = torch.arange(H, device=dev)[:, None, None]

    qb = q.reshape(B, H, nb, block, D)
    kb = k.reshape(B, H, nb, block, D)
    vb = v.reshape(B, H, nb, block, D)

    # one gather for K/V blocks, padding masks and segment ids, so the
    # plan's semantics cannot drift between them
    def gather_rows(x, per_head):
        """x: [B, nb, ...] (shared) or [B, H, nb, ...] -> [B, H, nb, A,
        ...] by the plan."""
        return x[:, heads, idx] if per_head else x[:, idx]

    kg = gather_rows(kb.float(), per_head=True)            # [B,H,nb,A,bl,D]
    vg = gather_rows(vb, per_head=True)

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    ninf = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    # scores [B, H, nb, block, A, block]
    s = torch.einsum("bhiqd,bhiakd->bhiqak", qb.float(), kg) * scale
    s = s + torch.where(amask, zero, ninf)[None, :, :, None, :, None]
    if causal:
        ar = torch.arange(block, device=dev)
        qpos = (torch.arange(nb, device=dev)[:, None, None, None] * block
                + ar[None, :, None, None])                 # [nb,bl,1,1]
        kpos = idx[:, :, None, :, None] * block + ar       # [H,nb,1,A,bl]
        cmask = kpos <= qpos[None]                         # [H,nb,bl,A,bl]
        s = s + torch.where(cmask, zero, ninf)[None]
    if attn_mask is not None:
        # attn_mask [B, S] key padding mask (1 = keep), ref's
        # key_padding_mask
        mg = gather_rows(attn_mask.reshape(B, nb, block).to(dev),
                         per_head=False)                   # [B,H,nb,A,bl]
        s = s + torch.where(mg[:, :, :, None].bool(), zero, ninf)
    if segment_ids is not None:
        # packed layout: [B, S] int ids; key-side ids gather by the same
        # plan as the K blocks, the query side reshapes in place
        segb = segment_ids.reshape(B, nb, block).to(dev)   # [B,nb,bl]
        sg = gather_rows(segb, per_head=False)             # [B,H,nb,A,bl]
        same = segb[:, None, :, :, None, None] == sg[:, :, :, None]
        s = s + torch.where(same, zero, ninf)
    sf = s.reshape(B, H, nb, block, A * block)
    m = sf.amax(dim=-1, keepdim=True)
    p = torch.exp(sf - m)
    denom = p.sum(dim=-1, keepdim=True)
    p = (p / denom.clamp(min=1e-30)).to(q.dtype)
    p = p.reshape(B, H, nb, block, A, block)
    out = torch.einsum("bhiqak,bhiakd->bhiqd", p, vg)
    # a fully masked query row (every gathered key cross-segment or
    # padding under a diagonal-free layout) never lifts m off NEG_INF;
    # exp(s - m) == 1 there would average garbage V rows, so it gives 0
    keep = m.reshape(B, H, nb, block, 1) > NEG_INF / 2
    out = torch.where(keep, out, torch.zeros((), dtype=out.dtype,
                                             device=dev))
    return out.reshape(B, H, S, D)


class SparseSelfAttention:
    """ref: deepspeed/ops/sparse_attention/sparse_self_attention.py: the
    module wrapper caching the per-seqlen layout."""

    def __init__(self, sparsity_config: SparsityConfig,
                 causal: Optional[bool] = None):
        self.config = sparsity_config
        self.causal = (causal if causal is not None
                       else getattr(sparsity_config, "attention",
                                    "bidirectional") == "unidirectional")
        self._layouts = {}

    def layout(self, seq_len: int) -> np.ndarray:
        if seq_len not in self._layouts:
            self._layouts[seq_len] = self.config.make_layout(seq_len)
        return self._layouts[seq_len]

    def __call__(self, q, k, v, attn_mask=None, segment_ids=None,
                 heads: Optional[slice] = None):
        """q/k/v [B, H, S, D]; ``heads``: the slice of the layout's heads
        these q/k/v hold (a tensor-parallel rank's), all of them by
        default."""
        S = q.shape[2]
        lay = self.layout(S)
        if heads is not None:
            lay = lay[heads]
        return sparse_attention(q, k, v, lay, self.config.block,
                                causal=self.causal, attn_mask=attn_mask,
                                segment_ids=segment_ids)

    def density(self, seq_len: int) -> float:
        lay = self.layout(seq_len)
        return float(lay.mean())
