"""Paged KV store, page writers and the per-layer paged-attention step
(port of ``deepspeed_tpu/inference/kernels.py``).

KV lives in fixed-size pages ``[L, KV, num_pages, page_size, Dh]``; each
sequence owns a list of page ids (its row of the page table).  The page
writers update one layer's pages IN PLACE (the JAX engine donates the
cache buffers to the same effect) and keep the reference's drop-on-
overflow contract without a device-to-host sync.  Under
``kv_tier.quantized_resident`` the pages hold int8 codes with one f32 scale
per token row, written by the ``*_quant`` writers with the kv_tier codec.
Attention runs a CUDA paged kernel
(:mod:`~deepspeed_tpu_torch.inference.paged_attention_cuda`) or its plain
version, as :func:`resolve_serving_kernels` decided at build.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deepspeed_tpu_torch._device import resolve_device
from deepspeed_tpu_torch.inference.paged_attention_cuda import (
    paged_attention_reference, paged_chunk_attention,
    paged_chunk_attention_quant, paged_chunk_attention_reference,
    paged_chunk_attention_v1, paged_decode_attention,
    paged_decode_attention_quant, paged_decode_attention_v1)
from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.attention import flash_attention
from deepspeed_tpu_torch.ops.quant_cuda import (quantize_rows,
                                                quantize_rows_reference)

PAGED_ATTENTION_MODES = ("auto", "xla", "pallas_v1", "pallas_v2")
FUSED_SAMPLING_MODES = ("auto", "off", "on")


# ------------------------------------------------------------- page store
@dataclasses.dataclass
class PagedKVCache:
    """Paged KV store for one layer stack.

    k/v: [L, KV, num_pages, page_size, Dh]; table: [B, max_pages] int32
    page ids; seq_lens: [B] int32 valid token counts.  Int8-resident mode
    (``kv_tier.quantized_resident``): k/v hold int8 codes and
    k_scale/v_scale the per-token-row f32 scales [L, KV, num_pages,
    page_size, 1]; None on the plain path."""

    k: torch.Tensor
    v: torch.Tensor
    table: torch.Tensor
    seq_lens: torch.Tensor
    page_size: int
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @classmethod
    def alloc(cls, n_layers: int, n_kv: int, num_pages: int, page_size: int,
              head_dim: int, batch: int, max_seq: int, dtype=torch.bfloat16,
              device=None) -> "PagedKVCache":
        """An empty cache whose row b owns pages ``b * max_pages ...
        (b + 1) * max_pages - 1`` (the JAX package's static round-robin
        table; the serving engine's allocator hands pages out instead).
        ``device`` None means CUDA, which raises where there is none."""
        device = resolve_device(device)
        max_pages = -(-max_seq // page_size)
        if num_pages < batch * max_pages:
            raise ValueError(
                f"num_pages {num_pages} < batch*max_pages {batch * max_pages}")
        shape = (n_layers, n_kv, num_pages, page_size, head_dim)
        table = (torch.arange(batch, dtype=torch.int32)[:, None] * max_pages
                 + torch.arange(max_pages, dtype=torch.int32)[None])
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   table=table.to(device),
                   seq_lens=torch.zeros((batch,), dtype=torch.int32,
                                        device=device),
                   page_size=page_size)


class PageAllocator:
    """Host-side refcounted page allocator with an optional
    content-addressed warm pool (continuous-batching bookkeeping +
    automatic prefix caching).

    Every page handed out carries a reference count: ``allocate`` mints
    pages at refcount 1, ``share`` maps already-cached pages into
    another sequence with a refcount bump, and ``release`` drops one
    reference per owned page — a page is only reclaimable when its LAST
    owner releases it.  Full pages whose token span has been
    content-addressed via ``publish`` do not return to the free list on
    their last release: they enter a warm pool (capped at
    ``cache_pages``, eviction-ordered ``lru`` or ``fifo``) where their
    KV stays resident and matchable, and are only reclaimed when
    ``allocate`` finds the free list dry — allocation pressure, not
    request completion, is what erases cache.

    ``cache_pages=0`` (the default) disables publishing entirely and
    restores the classic free-list semantics: one owner per page,
    release returns pages immediately.

    Tiering (the ZeRO-Infinity idea applied to KV pages): with a
    ``spill`` pool installed (:class:`~deepspeed_tpu_torch.inference.kv_tier.
    KVTierPool`) and a ``demote_hook``, a warm page reclaimed by
    ``_evict_one`` is offered to the hook first — on success the page's
    KV survives on a host/NVMe tier and its content key keeps matching
    through :meth:`lookup_tiered`, so eviction demotes instead of
    forgetting.  Tier hits re-enter HBM through PROMOTION: the engine
    allocates a fresh page, marks it with :meth:`begin_promotion`
    (unmatchable and unreclaimable until the payload lands), and
    :meth:`finish_promotion` publishes it once the upload completes.
    ``available`` excludes in-flight promotions so admission can never
    double-count a page as both warm and free.
    """

    def __init__(self, num_pages: int, cache_pages: int = 0,
                 eviction: str = "lru"):
        if eviction not in ("lru", "fifo"):
            raise ValueError(
                f"eviction must be 'lru' or 'fifo', got {eviction!r}")
        self.free = list(range(num_pages - 1, -1, -1))
        self.owned = {}           # seq_id -> [page, ...]
        self.refs = {}            # page -> live reference count
        self.index = {}           # content key -> page (published)
        self.key_of = {}          # page -> content key
        self.pool = {}            # page -> eviction priority (refs == 0)
        self.cache_pages = int(cache_pages)
        self.eviction = eviction
        self._published_at = {}   # page -> publish tick (fifo priority)
        self._tick = 0
        self.evicted = 0          # lifetime evicted-page count
        self.published = 0        # lifetime published-page count
        # ---- KV tiering (installed by the engine when kv_tier is on)
        self.spill = None         # KVTierPool: demoted-page index
        self.demote_hook = None   # (page, key) -> bool: capture to tier
        self.promoting = {}       # page -> key, promotion in flight
        self._parked = []         # promoting pages released pre-landing
        self.demoted = 0          # lifetime demoted-page count
        self.promoted = 0         # lifetime promoted-page count

    @property
    def available(self) -> int:
        """Pages an ``allocate`` could obtain right now: the free list
        plus the warm pool (reclaimed on demand).  Pages with an
        in-flight promotion are structurally excluded — they are owned
        (never in either list), ``_publish_full_pages`` skips them so
        they cannot enter the warm pool, and ``release`` PARKS rather
        than frees them — so an async upload can never land in a page
        this count let someone else re-allocate."""
        return len(self.free) + len(self.pool)

    def allocate(self, seq_id, n: int = 1):
        """Mint ``n`` fresh pages (refcount 1) for ``seq_id``, evicting
        warm-pool pages oldest-first when the free list runs dry."""
        if self.available < n:
            raise MemoryError(f"out of KV pages (need {n}, "
                              f"free {len(self.free)}, "
                              f"cached {len(self.pool)})")
        got = []
        for _ in range(n):
            p = self.free.pop() if self.free else self._evict_one()
            self.refs[p] = 1
            got.append(p)
        self.owned.setdefault(seq_id, []).extend(got)
        return got

    def _evict_one(self) -> int:
        p = min(self.pool, key=self.pool.get)
        del self.pool[p]
        key = self.key_of.pop(p)
        del self.index[key]
        self._published_at.pop(p, None)
        # demote instead of drop: the hook copies the page's KV to the
        # spill tier (device->host), and the key keeps matching there —
        # the physical page is reclaimed either way
        if self.demote_hook is not None and self.demote_hook(p, key):
            self.demoted += 1
        else:
            self.evicted += 1
        return p

    def oldest_warm(self, n: int):
        """The ``n`` oldest warm-pool pages with their keys — the
        watermark-demotion candidates (bookkeeping untouched; pair with
        :meth:`reclaim_warm` after the engine captured their KV)."""
        order = sorted(self.pool, key=self.pool.get)[:max(n, 0)]
        return [(p, self.key_of[p]) for p in order]

    def reclaim_warm(self, pages, demoted: bool) -> None:
        """Remove warm pages from the pool + index and free them,
        counting them demoted (their KV lives on the spill tier now) or
        evicted (dropped).  Pages that left the pool since
        :meth:`oldest_warm` (revived by a share) are skipped."""
        for p in pages:
            if p not in self.pool:
                continue
            del self.pool[p]
            del self.index[self.key_of.pop(p)]
            self._published_at.pop(p, None)
            self.free.append(p)
            if demoted:
                self.demoted += 1
            else:
                self.evicted += 1

    def lookup(self, keys):
        """Longest cached prefix: walk the chained keys in order and
        return the matched pages up to the first miss."""
        pages = []
        for k in keys:
            p = self.index.get(k)
            if p is None:
                break
            pages.append(p)
        return pages

    def lookup_tiered(self, keys):
        """Longest cached prefix across ALL tiers: walk the chained
        keys and return ``("hbm", page)`` / ``("tier", key)`` matches
        up to the first total miss.  HBM wins when a span is in both
        (a promoted page's spill copy is kept as a free re-demote)."""
        out = []
        for k in keys:
            p = self.index.get(k)
            if p is not None:
                out.append(("hbm", p))
                continue
            if self.spill is not None and self.spill.has(k):
                out.append(("tier", k))
                continue
            break
        return out

    # ------------------------------------------------------- promotion
    # (tier hit -> fresh HBM page; the engine streams the payload back
    # and calls finish; the page is quarantined from reclaim meanwhile)
    def begin_promotion(self, page: int, key: bytes) -> None:
        """Mark an allocated page as receiving a tier promotion: it
        must not be published (content hasn't landed) nor ever handed
        back out before :meth:`finish_promotion` or
        :meth:`cancel_promotion` resolves it."""
        if page not in self.refs:
            raise ValueError(f"begin_promotion of unowned page {page}")
        self.promoting[page] = key

    def finish_promotion(self, page: int, key: bytes) -> bool:
        """Payload landed: publish the page under its content key so
        concurrent same-prefix admissions share it.  A page whose owner
        vanished mid-flight (parked by ``release``) just frees.
        Returns True when the page was newly indexed."""
        self.promoting.pop(page, None)
        if page in self._parked:
            self._parked.remove(page)
            self.free.append(page)
            return False
        self.promoted += 1
        return self.publish(page, key)

    def cancel_promotion(self, page: int) -> None:
        """Abandon an in-flight promotion (preemption): the page stays
        owned by its sequence (released through the normal path) unless
        it was already parked, in which case it frees now."""
        self.promoting.pop(page, None)
        if page in self._parked:
            self._parked.remove(page)
            self.free.append(page)

    def share(self, seq_id, pages) -> None:
        """Map already-cached pages into ``seq_id``'s ownership with a
        refcount bump each; warm-pool pages revive (leave the pool) —
        the prefix-hit path.  Shared pages are READ-ONLY by contract:
        the engine only ever writes at a sequence's own frontier, which
        lies past every shared page."""
        for p in pages:
            if p in self.pool:
                del self.pool[p]
                self.refs[p] = 1
            else:
                self.refs[p] += 1
        if pages:
            self.owned.setdefault(seq_id, []).extend(pages)

    def publish(self, page: int, key: bytes) -> bool:
        """Content-address a live FULL page so future prompts can match
        it.  Dedup keeps the first publisher (an identical span already
        indexed under ``key`` wins); a page publishes at most once.
        Returns True when the page was newly indexed."""
        if self.cache_pages <= 0 or key in self.index \
                or page in self.key_of:
            return False
        if page not in self.refs:
            raise ValueError(f"publish of unowned page {page}")
        self.index[key] = page
        self.key_of[page] = key
        self._tick += 1
        self._published_at[page] = self._tick
        self.published += 1
        return True

    def writable(self, page: int) -> bool:
        """True when ``page`` may be written in place: exactly one live
        reference and never published.  A published page's CONTENT is
        pinned by its content key (a write would poison the index for
        every future match), and a shared page belongs to other
        sequences too.  Structurally the engine only ever writes at a
        sequence's own frontier, which lies past every shared/published
        page; speculative decoding (a later slice) checks each page of
        its write window with this before writing drafts."""
        return self.refs.get(page, 0) == 1 and page not in self.key_of

    def release(self, seq_id) -> None:
        """Drop one reference per page owned by ``seq_id``.  Pages
        hitting refcount 0 return to the free list — unless published,
        in which case they enter the warm pool and keep their KV
        matchable until allocation pressure (or the pool cap) evicts
        them."""
        for p in reversed(self.owned.pop(seq_id, [])):
            self.refs[p] -= 1
            if self.refs[p]:
                continue
            del self.refs[p]
            if p in self.key_of:
                self._tick += 1
                self.pool[p] = (self._published_at[p]
                                if self.eviction == "fifo" else self._tick)
                while len(self.pool) > self.cache_pages:
                    self.free.append(self._evict_one())
            elif p in self.promoting:
                # released mid-promotion (preempt raced the upload):
                # park until the promotion resolves — freeing now could
                # hand the page to a new owner while the payload lands
                self._parked.append(p)
            else:
                self.free.append(p)


# ----------------------------------------------- per-layer page writers
# (one layer's pages [KV, P, ps, d], updated in place)
def _scatter_rows(planes, table, start, page_size: int) -> None:
    """Write rows ``new`` [B, C, KV, d] at positions ``start + 0..C-1`` of
    each row into their page stores, for every ``(store, new)`` of
    ``planes``, dropping positions at or past the row's capacity
    (``max_pages * page_size``) as the reference's ``mode="drop"`` scatter
    does.  A dropped position is redirected onto the slot of its row's
    last in-capacity position, carrying that position's own value, so the
    duplicate index writes an identical value and the drop needs no
    device-to-host sync.  A row with no in-capacity position rewrites its
    last slot with the value already there."""
    B, C = planes[0][1].shape[:2]
    mp = table.shape[1]
    cap = mp * page_size
    dev = planes[0][1].device
    c = torch.arange(C, device=dev)[None]                       # [1, C]
    last_ok = cap - 1 - start.long()                            # [B]
    c_eff = torch.minimum(c, last_ok[:, None])                  # [B, C]
    row_ok = c_eff >= 0
    pos = torch.where(row_ok, start.long()[:, None] + c_eff, cap - 1)
    page_id = torch.gather(table.long(), 1, pos // page_size)   # [B, C]
    in_page = pos % page_size
    for store, new in planes:
        src = c_eff.clamp(min=0)[:, :, None, None].expand(new.shape)
        vals = torch.gather(new, 1, src).to(store.dtype)        # [B,C,KV,d]
        vals = vals.permute(2, 0, 1, 3)                         # [KV,B,C,d]
        held = store[:, page_id, in_page]                       # [KV,B,C,d]
        store[:, page_id, in_page] = torch.where(
            row_ok[None, :, :, None], vals, held)


def _write_prompt(planes, table, page_size: int) -> None:
    """Bulk-write prompt rows ``new`` [B, T, KV, d] into pages from
    position 0 for every ``(store, new, pad_value)`` of ``planes``; the
    padded tail of the last page takes ``pad_value``."""
    B, T = planes[0][1].shape[:2]
    np_used = -(-T // page_size)
    pad = np_used * page_size - T
    ids = table[:, :np_used].reshape(-1).long()                 # [B*np]
    for store, new, pad_value in planes:
        KV, d = new.shape[2:]
        if pad:
            new = torch.cat(
                [new, new.new_full((B, pad, KV, d), pad_value)], dim=1)
        # [B, np, ps, KV, d] -> [KV, B*np, ps, d]
        blocks = new.reshape(B, np_used, page_size, KV, d) \
            .permute(3, 0, 1, 2, 4).reshape(KV, B * np_used, page_size, d)
        store[:, ids] = blocks.to(store.dtype)


def write_token_pages(pages_k, pages_v, new_k, new_v, table, seq_lens,
                      page_size: int):
    """Append one token's K/V ([B, KV, Dh]) at each sequence's frontier,
    in place; a sequence at capacity drops its write."""
    _scatter_rows([(pages_k, new_k[:, None]), (pages_v, new_v[:, None])],
                  table, seq_lens, page_size)
    return pages_k, pages_v


def write_prompt_pages(pages_k, pages_v, new_k, new_v, table,
                       page_size: int):
    """Bulk-write a fresh prompt's K/V ([B, T, KV, Dh]) into pages from
    position 0 (prefill of an empty cache), in place."""
    _write_prompt([(pages_k, new_k, 0), (pages_v, new_v, 0)], table,
                  page_size)
    return pages_k, pages_v


def write_chunk_pages(pages_k, pages_v, new_k, new_v, table, start,
                      page_size: int):
    """Write a mid-sequence chunk's K/V ([B, C, KV, Dh]) at each row's
    frontier ``start`` ([B] int32), in place; positions past a row's
    capacity are dropped."""
    _scatter_rows([(pages_k, new_k), (pages_v, new_v)], table, start,
                  page_size)
    return pages_k, pages_v


# ------------------------------------------- int8-resident page helpers
# (kv_tier.quantized_resident: the resident pool holds the SAME symmetric
# per-token-row int8 codec kv_tier.quantize_page uses on demote, so a
# promotion publishes stored codes directly and the attention kernel
# dequantises on chip.  These are the torch twins of the numpy codec in
# deepspeed_tpu_torch/inference/kv_tier.py: the rounding must stay
# identical or the lossless demote -> promote -> demote round trip breaks.)
def quantize_kv_rows(x, force_reference: bool = False):
    """Symmetric per-last-dim-row int8 quantisation of K/V rows on the
    device: ``x [..., Dh]`` -> ``(codes int8 [..., Dh], scales f32 [...,
    1])``, one group per row through B9 (:func:`~deepspeed_tpu_torch.ops.
    quant_cuda.quantize_rows`: the kernel on CUDA, its plain version on the
    CPU or with ``force_reference``).  Bit-equal to ``kv_tier.quantize_page``:
    ``scale = amax / 127`` as an f32 division, 1.0 where that is 0, ``x /
    scale`` rounds half to even."""
    rows = x.reshape(-1, x.shape[-1])
    codes, scale = (quantize_rows_reference(rows) if force_reference
                    else quantize_rows(rows))
    return codes.view(x.shape), scale.view(*x.shape[:-1], 1)


def dequantize_pages(codes, scales, dtype):
    """Dequantise int8 page codes with their per-row scales to ``dtype``:
    the plain arm's dequantisation (``f32(code) * scale``, then cast)."""
    return (codes.float() * scales).to(dtype)


def write_kv_quant_reference(pages_k, pages_ks, pages_v, pages_vs, new_k,
                             new_v, table, start, page_size: int):
    """The fused K/V write's plain version: quantise the rows ``new_k`` /
    ``new_v`` [B, C, KV, Dh] per token row (:func:`quantize_kv_rows` in its
    plain version) and write codes and scales into the int8 pages [KV, P,
    ps, Dh] / scales [KV, P, ps, 1], in place.  With ``start`` ([B] int32)
    row c of b lands at position ``start[b] + c``, positions at or past the
    row's capacity dropped (:func:`_scatter_rows`); with ``start`` None the
    rows are a fresh prompt from position 0 and the padded tail of its last
    page takes codes 0 with scale 1.0, the codec's all-zero row
    (:func:`_write_prompt`)."""
    kq, ks = quantize_kv_rows(new_k, force_reference=True)
    vq, vs = quantize_kv_rows(new_v, force_reference=True)
    if start is None:
        _write_prompt([(pages_k, kq, 0), (pages_ks, ks, 1.0), (pages_v, vq, 0),
                       (pages_vs, vs, 1.0)], table, page_size)
    else:
        _scatter_rows([(pages_k, kq), (pages_ks, ks), (pages_v, vq),
                       (pages_vs, vs)], table, start, page_size)


def write_kv_quant(pages_k, pages_ks, pages_v, pages_vs, new_k, new_v, table,
                   start, page_size: int, force_reference: bool = False):
    """One layer's int8-resident K/V write, the contract of
    :func:`write_kv_quant_reference`.  CPU tensors (or ``force_reference``,
    the ``xla`` arm's plain writes) take the plain version; CUDA tensors
    launch B9's fused entry (``csrc/quant.cu`` ``dstt_quantize_write_kv``:
    every K and V row quantised by the vector body's device functions and
    stored in its page slot, one launch) or raise.  The launch counts as
    one of B9's (``quantize_rows.launches``, body ``"vec"``)."""
    if force_reference or new_k.device.type == "cpu":
        return write_kv_quant_reference(pages_k, pages_ks, pages_v, pages_vs,
                                        new_k, new_v, table, start, page_size)
    name = "write_kv_quant"
    if not new_k.is_cuda:
        raise ValueError(f"{name}: unsupported device {new_k.device}")
    B, T, KV, Dh = new_k.shape
    _, P, ps, _ = pages_k.shape
    mp = table.shape[1]
    C = -(-T // ps) * ps if start is None else T
    if new_v.shape != new_k.shape or new_v.dtype != new_k.dtype \
            or new_k.dtype not in _build.F32_BF16:
        raise ValueError(f"{name}: new_k / new_v {tuple(new_k.shape)} "
                         f"{new_k.dtype} / {tuple(new_v.shape)} {new_v.dtype}")
    if Dh not in _build.HEAD_DIMS or ps != page_size \
            or pages_k.shape != (KV, P, ps, Dh) \
            or pages_v.shape != pages_k.shape:
        raise ValueError(f"{name}: pages {tuple(pages_k.shape)} / "
                         f"{tuple(pages_v.shape)} (page size {page_size}) do "
                         f"not take rows {tuple(new_k.shape)}")
    if table.shape != (B, mp) or table.dtype != torch.int32 or (
            start is not None and (start.shape != (B,)
                                   or start.dtype != torch.int32)):
        raise ValueError(f"{name}: want table [B, mp] and start [B] int32")
    if start is None and C > mp * ps:
        raise ValueError(f"{name}: a prompt of {T} tokens needs more than "
                         f"the table's {mp} pages")
    planes = (pages_k, pages_ks, pages_v, pages_vs)
    for i, (t, dt) in enumerate(zip(planes, (torch.int8, torch.float32) * 2)):
        want = (KV, P, ps, Dh if dt == torch.int8 else 1)
        if t.shape != want or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: plane {i} {tuple(t.shape)} {t.dtype}; "
                             f"want {want} {dt} contiguous")
    for t in (*planes, new_v, table) + (() if start is None else (start,)):
        if t.device != new_k.device:
            raise ValueError(f"{name}: inputs on {t.device} and "
                             f"{new_k.device}")
    nk, nv = new_k.contiguous(), new_v.contiguous()
    if nk.data_ptr() % 16 or nv.data_ptr() % 16 \
            or not table.is_contiguous() \
            or not (start is None or start.is_contiguous()):
        raise ValueError(f"{name}: new rows off a 16-byte boundary, or a "
                         f"strided table or start")
    err = _build.lib().dstt_quantize_write_kv(
        nk.data_ptr(), nv.data_ptr(), table.data_ptr(),
        None if start is None else start.data_ptr(), pages_k.data_ptr(),
        pages_ks.data_ptr(), pages_v.data_ptr(), pages_vs.data_ptr(), B, T,
        C, KV, Dh, P, ps, mp, _build.DTYPE_CODES[new_k.dtype],
        _build.stream_of(new_k))
    _build.check("dstt_quantize_write_kv", err)
    quantize_rows.launches += 1
    quantize_rows.body_launches["vec"] += 1


def write_token_pages_quant(pages_k, pages_ks, pages_v, pages_vs, new_k,
                            new_v, table, seq_lens, page_size: int,
                            force_reference: bool = False):
    """:func:`write_token_pages` for the int8-resident store: quantise the
    appended rows ([B, KV, Dh]) on the device and write codes and scales, in
    place, with the same frontier and drop rule (:func:`write_kv_quant`).
    Scale stores are ``[KV, P, ps, 1]`` f32."""
    write_kv_quant(pages_k, pages_ks, pages_v, pages_vs, new_k[:, None],
                   new_v[:, None], table, seq_lens, page_size,
                   force_reference)
    return pages_k, pages_ks, pages_v, pages_vs


def write_prompt_pages_quant(pages_k, pages_ks, pages_v, pages_vs, new_k,
                             new_v, table, page_size: int,
                             force_reference: bool = False):
    """:func:`write_prompt_pages` for the int8-resident store, quantising
    per token row; the padded tail of the last page holds codes 0 with
    scale 1.0 (the codec's all-zero row)."""
    write_kv_quant(pages_k, pages_ks, pages_v, pages_vs, new_k, new_v, table,
                   None, page_size, force_reference)
    return pages_k, pages_ks, pages_v, pages_vs


def write_chunk_pages_quant(pages_k, pages_ks, pages_v, pages_vs, new_k,
                            new_v, table, start, page_size: int,
                            force_reference: bool = False):
    """:func:`write_chunk_pages` for the int8-resident store (split-fuse
    continuation chunks at per-row frontiers), in place."""
    write_kv_quant(pages_k, pages_ks, pages_v, pages_vs, new_k, new_v, table,
                   start, page_size, force_reference)
    return pages_k, pages_ks, pages_v, pages_vs


# --------------------------------------------------- kernel dispatch policy
@dataclasses.dataclass
class KernelsConfig:
    """The ``kernels`` config block: ``paged_attention`` auto | xla |
    pallas_v1 | pallas_v2 and ``fused_sampling`` auto | off | on, the field
    names of the JAX package.  In the port ``pallas_v2`` names the CUDA
    paged kernel and ``on`` the CUDA greedy kernel; ``xla`` / ``off`` name
    their plain PyTorch versions (the reference's A/B arms)."""

    paged_attention: str = "auto"
    fused_sampling: str = "auto"

    def __post_init__(self):
        if self.paged_attention not in PAGED_ATTENTION_MODES:
            raise ValueError(
                f"kernels.paged_attention must be one of "
                f"{'|'.join(PAGED_ATTENTION_MODES)}, got "
                f"{self.paged_attention!r}")
        if self.fused_sampling not in FUSED_SAMPLING_MODES:
            raise ValueError(
                f"kernels.fused_sampling must be one of "
                f"{'|'.join(FUSED_SAMPLING_MODES)}, got "
                f"{self.fused_sampling!r}")

    @classmethod
    def coerce(cls, obj) -> "KernelsConfig":
        if obj is None:
            return cls()
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, dict):
            known = {f.name for f in dataclasses.fields(cls)}
            return cls(**{k: str(v) for k, v in obj.items() if k in known})
        raise TypeError(f"kernels must be a dict or KernelsConfig, got "
                        f"{type(obj).__name__}")


@dataclasses.dataclass(frozen=True)
class ServingKernelPolicy:
    """The dispatch an engine build resolved: ``paged_attention`` is
    ``pallas_v2`` (the CUDA paged kernels B5 / B7), ``pallas_v1`` (the
    split-key CUDA kernel B8) or ``xla`` (plain); ``fused_sampling`` is
    ``on`` (CUDA kernel) or ``off`` (plain)."""

    paged_attention: str
    fused_sampling: str

    def as_dict(self) -> dict:
        return {"paged_attention": self.paged_attention,
                "fused_sampling": self.fused_sampling}


def resolve_serving_kernels(kernels=None, *,
                            device=None) -> ServingKernelPolicy:
    """Resolve the serving kernel policy ONCE, at engine build.  ``auto``
    takes the CUDA kernels (``pallas_v2``, ``on``) on a CUDA device and the
    plain versions on the CPU; there is no shape gate (the TPU's measured
    crossovers do not carry over).  ``pallas_v1`` names the v1 A/B arm,
    B8."""
    if isinstance(kernels, ServingKernelPolicy):
        return kernels
    cfg = KernelsConfig.coerce(kernels)
    on_cuda = torch.device("cuda" if device is None else device).type \
        == "cuda"
    paged = cfg.paged_attention
    if paged == "auto":
        paged = "pallas_v2" if on_cuda else "xla"
    fused = cfg.fused_sampling
    if fused == "auto":
        fused = "on" if on_cuda else "off"
    return ServingKernelPolicy(paged_attention=paged, fused_sampling=fused)


# --------------------------------------------- shared per-layer dispatch
def paged_attention_step(q, k, v, kp, vp, table, start, page_size: int, *,
                         continuation: bool, prefill: bool,
                         paged_kernel: str, flash_force_reference: bool,
                         kps=None, vps=None):
    """The per-layer paged-attention step: page writes (in place) plus the
    attention for the phase — chunked-prefill continuation, whole-prompt
    prefill (empty cache), or single-token decode.

    q: [B, T, H, Dh]; k/v: [B, T, KV, Dh]; kp/vp: one layer's pages.
    ``paged_kernel``: ``pallas_v2`` (B5, or B7 on int8 pages),
    ``pallas_v1`` (B8) or ``xla`` (the plain versions); a kernel wrapper
    takes its plain version on CPU tensors.  ``kps``/``vps`` non-None
    selects the int8-resident path: kp/vp hold int8 codes, kps/vps the
    per-token-row f32 scales, ``pallas_v2`` writes them through B9's fused
    K/V write (one launch a layer), and ``xla`` writes them through its
    plain version and dequantises with :func:`dequantize_pages` to q's
    dtype before the plain versions (there is no int8 ``pallas_v1``).
    Returns attn [B, T, H, Dh]."""
    quant = kps is not None
    if quant and paged_kernel == "pallas_v1":
        raise ValueError("int8-resident pages have no pallas_v1 kernel "
                         "(use xla or pallas_v2)")
    v2, v1 = paged_kernel == "pallas_v2", paged_kernel == "pallas_v1"
    if continuation and q.shape[1] > 1:
        if quant:
            write_chunk_pages_quant(kp, kps, vp, vps, k, v, table, start,
                                    page_size, force_reference=not v2)
            if v2:
                return paged_chunk_attention_quant(q, kp, kps, vp, vps,
                                                   table, start)
            return paged_chunk_attention_reference(
                q, dequantize_pages(kp, kps, q.dtype),
                dequantize_pages(vp, vps, q.dtype), table, start)
        write_chunk_pages(kp, vp, k, v, table, start, page_size)
        if v2:
            return paged_chunk_attention(q, kp, vp, table, start)
        if v1:
            return paged_chunk_attention_v1(q, kp, vp, table, start)
        return paged_chunk_attention_reference(q, kp, vp, table, start)
    if prefill:
        attn = flash_attention(q, k, v, causal=True,
                               force_reference=flash_force_reference)
        if quant:
            write_prompt_pages_quant(kp, kps, vp, vps, k, v, table,
                                     page_size, force_reference=not v2)
        else:
            write_prompt_pages(kp, vp, k, v, table, page_size)
        return attn
    lens = start + 1
    if quant:
        write_token_pages_quant(kp, kps, vp, vps, k[:, 0], v[:, 0], table,
                                start, page_size, force_reference=not v2)
        if v2:
            return paged_decode_attention_quant(q[:, 0], kp, kps, vp, vps,
                                                table, lens)[:, None]
        return paged_attention_reference(
            q[:, 0], dequantize_pages(kp, kps, q.dtype),
            dequantize_pages(vp, vps, q.dtype), table, lens)[:, None]
    write_token_pages(kp, vp, k[:, 0], v[:, 0], table, start, page_size)
    if v2:
        return paged_decode_attention(q[:, 0], kp, vp, table, lens)[:, None]
    if v1:
        return paged_decode_attention_v1(q[:, 0], kp, vp, table,
                                         lens)[:, None]
    return paged_attention_reference(q[:, 0], kp, vp, table, lens)[:, None]


def paged_forward_prelude(cache: PagedKVCache, tokens, continuation: bool):
    """Shared preamble of ``forward_paged``: the page size, the per-row
    start offsets, and whether this is a whole-prompt prefill (which must
    find an empty cache).  Returns (ps, start, prefill)."""
    ps = cache.k.shape[3]
    start = cache.seq_lens
    prefill = tokens.shape[1] > 1 and not continuation
    if prefill and int(start.max()) != 0:
        raise ValueError(
            "forward_paged prefill (T>1) requires an empty cache; pass "
            "continuation=True for chunked prefill")
    return ps, start, prefill
