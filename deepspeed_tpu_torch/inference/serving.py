"""Continuous-batching serving loop (port of the scheduler core of
``deepspeed_tpu/inference/serving.py``).

The host-side :class:`ServingEngine` owns everything dynamic — a FIFO of
requests, a slot table (batch row <-> request), the
:class:`~deepspeed_tpu_torch.inference.kernels.PageAllocator` free list and
per-slot sequence lengths — and drives three device programs over one
paged KV cache: whole-prompt prefill (one admission), chunked prefill
(split-fuse: ``prefill_chunk`` tokens of one slot) and a batched decode of
``decode_chunk`` tokens for every ready slot.  Each ``step()`` admits what
slots and pages allow, absorbs one chunk per prefilling slot, samples
every prefill-boundary token in one batched fetch, then decodes.  When the
pool runs dry the youngest sequence is preempted (pages released, request
requeued for recompute).

Conventions kept from the reference:
- prompts pad to ``prefill_bucket`` multiples; the padded tail's K/V lands
  past the row's seq_len and is never attended to;
- inactive slots' table rows point at a reserved TRASH page (the last page):
  the decode step writes a token for every row, and dead rows write there;
- the KV pages update in place on the device (the JAX engine donates them);
- sampling stays on the device: the K decode steps of a chunk feed each
  sampled token to the next step, and the host reads the [B, K] tokens
  once per chunk.

Automatic prefix caching (``prefix_cache``): full pages are published
under chained content keys; an admission shares its prompt's longest
cached page-aligned prefix read-only and prefills only the suffix in
continuation chunks.  The KV tier (``kv_tier``, needs ``prefix_cache``):
warm pages reclaimed under pressure (or past ``demote_watermark``) demote
to a host pool instead of dropping, and a later admission matching a
demoted span promotes it back into fresh pages; ``quantized_resident``
keeps the device pages as int8 codes with per-token-row scales.

Int8 weight-only serving (``weight_dtype="int8"``): the family builders
(``llama_serving_engine``, ``gpt2_serving_engine``,
``mixtral_serving_engine``) quantize every matrix leaf on the engine's
device (kernel B9 on CUDA) and the forward dequantizes one layer at a
time.

Blocks of the reference engine that this slice does not port (mesh,
telemetry, tracing, speculative, slo, faults, shedding, history,
incidents, devprof, comm, zero_inference) raise ``NotImplementedError``
when enabled; they are never ignored.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import weakref
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from deepspeed_tpu_torch._device import resolve_device
from deepspeed_tpu_torch._tree import tree_map
from deepspeed_tpu_torch.config import KVTierConfig, PrefixCacheConfig
from deepspeed_tpu_torch.faults import ChecksumError
from deepspeed_tpu_torch.inference.kernels import (PagedKVCache,
                                                   PageAllocator,
                                                   resolve_serving_kernels)
from deepspeed_tpu_torch.inference.kv_tier import (KVTierPool, from_host,
                                                   to_host)
from deepspeed_tpu_torch.inference.quantized import quantize_for_inference
from deepspeed_tpu_torch.inference.prefix_cache import (extend_page_keys,
                                                        matchable_pages,
                                                        page_keys)
from deepspeed_tpu_torch.ops.sampling_cuda import (fused_sample_rows,
                                                   greedy_rows_reference,
                                                   with_temperature)

# enabled-when-set blocks of the reference engine, and the slice that
# ports each
UNPORTED_BLOCKS = {
    "mesh": "the distributed slice",
    "telemetry": "the control-plane slice",
    "tracing": "the control-plane slice",
    "speculative": "the serving-extensions slice",
    "drafter": "the serving-extensions slice",
    "slo": "the control-plane slice",
    "faults": "the control-plane slice",
    "shed_queue_depth": "the control-plane slice",
    "shed_expired_deadline": "the control-plane slice",
    "history": "the control-plane slice",
    "incidents": "the control-plane slice",
    "devprof": "the control-plane slice",
    "comm": "the distributed slice",
    "zero_inference": "the serving-extensions slice",
}


# admission looks this many requests past a queue head whose pages do not
# fit (the reference engine's default), so one large request does not
# stall the queue
ADMIT_LOOKAHEAD = 4

# promotion deferral cap: how many scheduler iterations one slot's prefill
# may stand aside while its tier reads are still in flight before it
# blocks on the fence (bounds starvation when the promoting slot is the
# only work)
_KV_PROMO_DEFER_CAP = 16

logger = logging.getLogger(__name__)


def _enabled(value) -> bool:
    """The reference's opt-in rule for a config block: None/False/0 are
    off, a dict is on unless it says ``enabled: False``, a config object
    is on unless its ``enabled`` is false, anything else truthy is on."""
    if value is None or value is False or value == 0:
        return False
    if isinstance(value, dict):
        return value.get("enabled", True) is not False
    return bool(getattr(value, "enabled", True))


def _reject_unported(blocks: Dict[str, Any]) -> None:
    for name, value in blocks.items():
        if _enabled(value):
            raise NotImplementedError(
                f"serving block {name!r} is not ported to deepspeed_tpu_torch "
                f"yet; it comes with {UNPORTED_BLOCKS[name]}")


def _sample_rows(logits: torch.Tensor, temps,
                 generator=None) -> torch.Tensor:
    """Plain batched sampler: [B, V] logits + host temps [B] -> [B] int32.
    Temperature-0 rows take :func:`greedy_rows_reference`, the plain
    version the greedy kernel is held to; the others draw categorically at
    their temperature from ``generator``."""
    return with_temperature(logits, greedy_rows_reference(logits), temps,
                            generator)


class EngineClosed(RuntimeError):
    """``submit`` after ``shutdown()``: the engine can never serve it."""


@dataclasses.dataclass
class RequestShed:
    """Typed admission rejection (load shedding; the shedding blocks come
    with the control-plane slice, so this engine never produces one)."""

    req_id: Any
    reason: str
    tier: Optional[str] = None


@dataclasses.dataclass
class RequestFailed:
    """Typed per-request failure: an exception in this request's
    admission failed THIS request, its pages were released and the engine
    kept serving."""

    req_id: Any
    reason: str
    error: str = ""
    tier: Optional[str] = None
    generated: int = 0


RequestResult = Union[List[int], RequestShed, RequestFailed]


@dataclasses.dataclass
class Request:
    req_id: Any
    tokens: List[int]                  # prompt
    max_new_tokens: int = 32
    temperature: float = 0.0           # 0 -> greedy
    # chained prefix-cache keys of the full pages (computed lazily, grown
    # as pages fill; survives preemption)
    page_keys: Optional[List[bytes]] = None


@dataclasses.dataclass
class _Promotion:
    """One admission's in-flight tier -> device page promotion: the demoted
    keys being streamed back, their freshly allocated target pages, and the
    double-buffered reader driving the transfer.  ``primed`` holds group
    0's tier reads, submitted at admission; ``deferred`` counts the steps
    the slot's prefill stood aside for them."""

    keys: List[bytes]
    page_map: Dict[bytes, int]         # key -> target page
    reader: Any                        # param_stream.TierPageReader
    primed: Optional[list] = None
    deferred: int = 0


@dataclasses.dataclass
class _Slot:
    req: Request
    seq_len: int                       # tokens resident in the KV cache
    generated: List[int]
    seq_id: int = -1                   # PageAllocator owner key
    prefill_done: int = -1             # chunked prefill progress; -1 = done
    promo: Optional[_Promotion] = None  # in-flight tier-page promotion

    @property
    def prefilling(self) -> bool:
        return 0 <= self.prefill_done < len(self.req.tokens)


def _weak_method(bound):
    """``bound`` as a callable that does not keep its object alive."""
    ref = weakref.WeakMethod(bound)
    return lambda *args: ref()(*args)


class ServingEngine:
    """Host scheduler driving a paged-cache model on one device.

    ``prefill_fn`` / ``decode_fn`` / ``chunk_prefill_fn``: callables with the
    :func:`~deepspeed_tpu_torch.models.llama.forward_paged` contract
    ``(params, tokens, cache) -> (logits, cache)``; built for Llama by
    :func:`llama_serving_engine`.  ``device=None`` means CUDA and raises
    without it; the plain PyTorch path runs with ``device="cpu"``.
    ``prefix_cache`` / ``kv_tier``: the config blocks of the JAX package
    (dict, bool, config object or None).
    """

    def __init__(self, params, prefill_fn, decode_fn, *,
                 n_layers: int, n_kv: int, head_dim: int,
                 max_batch: int = 4, page_size: int = 16,
                 num_pages: int = 128, max_seq: int = 256,
                 prefill_bucket: int = 32, eos_token_id: Optional[int] = None,
                 cache_dtype=torch.bfloat16, seed: int = 0,
                 decode_chunk: int = 1, prefill_chunk: int = 0,
                 chunk_prefill_fn=None, kernels=None, device=None,
                 prefix_cache=None, kv_tier=None, **blocks):
        unknown = set(blocks) - set(UNPORTED_BLOCKS)
        if unknown:
            raise TypeError(f"unexpected ServingEngine arguments "
                            f"{sorted(unknown)}")
        _reject_unported(blocks)
        self.device = resolve_device(device)
        self.params = params
        self.decode_chunk = int(decode_chunk)
        if self.decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, got {decode_chunk}")
        # split-fuse: prompts absorbed prefill_chunk tokens per iteration
        # BETWEEN decode steps; 0 = whole prompt in one bucketed prefill
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk and chunk_prefill_fn is None:
            raise ValueError(
                "prefill_chunk > 0 needs chunk_prefill_fn — a (params, "
                "tokens, cache) step that attends over history + chunk "
                "(forward_paged(..., continuation=True))")
        self.eos = eos_token_id
        self.page_size = page_size
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.prefill_bucket = prefill_bucket
        self.max_pages_per_seq = -(-max_seq // page_size)
        # last page is the sacrificial target for inactive-slot writes
        self.trash_page = num_pages - 1
        # ---- automatic prefix caching: the allocator becomes a
        # refcounted content-addressed pool; its warm (refcount-0) pages
        # may hold at most pool_cap of the usable pages
        pc = PrefixCacheConfig.coerce(prefix_cache)
        self.prefix_cache = pc
        self._pc_on = pc.enabled
        usable = num_pages - 1
        self.allocator = PageAllocator(usable,
                                       cache_pages=pc.pool_cap(usable),
                                       eviction=pc.eviction)
        if self._pc_on and chunk_prefill_fn is None:
            raise ValueError(
                "prefix_cache needs chunk_prefill_fn — cache-hit "
                "admissions prefill only the uncached suffix via the "
                "continuation forward (forward_paged(..., "
                "continuation=True))")
        self.kernels = resolve_serving_kernels(kernels, device=self.device)
        # ---- tiered KV: coerced before the cache allocation, since
        # quantized_resident changes the device cache's layout
        kvt = KVTierConfig.coerce(kv_tier)
        self.kv_tier = kvt
        self._kvt_on = kvt.enabled
        self._quant_resident = kvt.enabled and kvt.quantized_resident
        if self._kvt_on and not self._pc_on:
            raise ValueError(
                "kv_tier needs the prefix_cache block — only published "
                "refcount-0 prefix-cache pages demote; without content "
                "addressing there is nothing to spill or match")
        if self._quant_resident and \
                self.kernels.paged_attention == "pallas_v1":
            raise ValueError(
                "kernels.paged_attention=pallas_v1 cannot serve int8-"
                "resident pages (kv_tier.quantized_resident) — there is "
                "no quantized v1 kernel; use xla or pallas_v2")
        # ---- the host tier: the allocator owns the index states, the
        # pool the payloads, this engine the device <-> host movement
        self._kv_pool: Optional[KVTierPool] = None
        self._kvt_wm_pages: Optional[int] = None
        if self._kvt_on:
            self._kv_pool = KVTierPool(
                kvt, page_shape=(n_layers, n_kv, page_size, head_dim),
                page_dtype=cache_dtype)
            self.allocator.spill = self._kv_pool
            # a weak hook: a bound method would make engine <-> allocator
            # a cycle, and a dropped engine would hold its weights and KV
            # pool on the card until the cycle collector ran
            self.allocator.demote_hook = _weak_method(self._demote_for_evict)
            if kvt.demote_watermark < 1.0 and self.allocator.cache_pages:
                self._kvt_wm_pages = int(
                    kvt.demote_watermark * self.allocator.cache_pages)
        self._sample_fn = (fused_sample_rows
                           if self.kernels.fused_sampling == "on"
                           else _sample_rows)
        self._prefill = prefill_fn
        self._decode = decode_fn
        self._chunk_prefill = chunk_prefill_fn
        self._table_host = np.full((max_batch, self.max_pages_per_seq),
                                   self.trash_page, np.int32)
        self.cache = self._alloc_cache(n_layers, n_kv, num_pages, page_size,
                                       head_dim, cache_dtype)
        # dirty flags: the device table/seq_lens re-upload only when the
        # slot composition changed since the last decode
        self._table_dirty = True
        self._lens_dirty = True
        self.slots: List[Optional[_Slot]] = [None] * max_batch
        # prefill-boundary sampling queue: (slot, logits row, temperature),
        # flushed as ONE batched sample + fetch per step
        self._pending_boundary: List[Tuple[int, torch.Tensor, float]] = []
        self.queue: "collections.deque[Request]" = collections.deque()
        self._seq_counter = 0
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.finished: Dict[Any, RequestResult] = {}
        self._newly_finished: List[Any] = []
        self.preempted = 0             # recompute preemptions so far
        self.decode_steps = 0          # batched decode steps (tokens/slot)
        self.prefill_chunks = 0        # split-fuse chunks absorbed
        # prefix-cache counts (the published/evicted/demoted/promoted
        # page counts live on the allocator)
        self.prefix_cache_hits = 0          # admissions matching >= 1 page
        self.prefix_cache_misses = 0
        self.prefix_cache_cached_tokens = 0   # prompt tokens not prefilled
        self.prefix_cache_prompt_tokens = 0   # prompt tokens admitted
        # kv-tier counts
        self.kv_tier_quant_resident_promotes = 0
        self.kv_tier_promote_deferrals = 0
        self.kv_tier_checksum_failures = 0
        self.kv_tier_fallback_events = 0
        self.kv_tier_fallback_pages = 0
        self._kvt_fault_streak = 0
        self._closed = False

    def _alloc_cache(self, n_layers, n_kv, num_pages, page_size, head_dim,
                     cache_dtype) -> PagedKVCache:
        shape = (n_layers, n_kv, num_pages, page_size, head_dim)
        table = self._put(self._table_host)
        seq_lens = self._put(np.zeros((self.max_batch,), np.int32))
        if self._quant_resident:
            # int8-resident pages: codes replace the dense planes and a
            # per-token-row f32 scale plane rides along; scales start at
            # ONE, the codec's convention for an all-zero row
            sshape = shape[:-1] + (1,)
            return PagedKVCache(
                k=torch.zeros(shape, dtype=torch.int8, device=self.device),
                v=torch.zeros(shape, dtype=torch.int8, device=self.device),
                table=table, seq_lens=seq_lens, page_size=page_size,
                k_scale=torch.ones(sshape, dtype=torch.float32,
                                   device=self.device),
                v_scale=torch.ones(sshape, dtype=torch.float32,
                                   device=self.device))
        return PagedKVCache(
            k=torch.zeros(shape, dtype=cache_dtype, device=self.device),
            v=torch.zeros(shape, dtype=cache_dtype, device=self.device),
            table=table, seq_lens=seq_lens, page_size=page_size)

    def _put(self, a) -> torch.Tensor:
        # a copy: the host arrays change under a live device tensor on CPU
        return torch.from_numpy(np.array(a)).to(self.device)

    def _view(self, table, start: int) -> PagedKVCache:
        """A one-row view of the cache over host table row ``table`` with
        its frontier at ``start`` (the page planes are shared)."""
        return dataclasses.replace(
            self.cache, table=self._put(table),
            seq_lens=self._put(np.full((1,), start, np.int32)))

    # ---------------------------------------------------------------- submit
    def submit(self, req_id, tokens, max_new_tokens: int = 32,
               temperature: float = 0.0) -> None:
        """Queue a request.  Raises :class:`EngineClosed` after
        :meth:`shutdown`, and ValueError for a request that could never
        complete (longer than ``max_seq`` or than the whole page pool)."""
        if self._closed:
            raise EngineClosed(f"request {req_id!r} submitted after shutdown")
        tokens = list(map(int, tokens))
        if not tokens:
            raise ValueError(f"request {req_id}: empty prompt")
        if len(tokens) + max_new_tokens > self.max_seq:
            raise ValueError(
                f"request {req_id}: prompt {len(tokens)} + "
                f"{max_new_tokens} new > max_seq {self.max_seq}")
        lifetime_pages = self._pages_needed(len(tokens) + max_new_tokens)
        if lifetime_pages > self.trash_page:
            raise ValueError(
                f"request {req_id}: needs {lifetime_pages} pages at full "
                f"length but the pool has {self.trash_page} — it could "
                "never complete even alone")
        self.queue.append(Request(req_id, tokens, max_new_tokens,
                                  temperature))

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def check_leaks(self) -> List[str]:
        """Page-accounting invariants; returns violations (empty = clean):
        each usable page sits in exactly one of {free list, warm pool,
        live-owned, parked}, refcounts match ownership multiplicity, every
        promoting page is owned or parked, and an idle engine owns nothing,
        promotes nothing, parks nothing and pins no tier entry."""
        al = self.allocator
        probs: List[str] = []
        owned_flat = [p for pages in al.owned.values() for p in pages]
        cnt = collections.Counter(al.free)
        cnt.update(al.pool.keys())     # keys() — a dict would be read
        cnt.update(set(owned_flat))    # as a counts mapping
        cnt.update(al._parked)
        missing = [p for p in range(self.trash_page) if cnt[p] != 1]
        if missing:
            probs.append(f"pages not in exactly one of free/warm/live/"
                         f"parked: {missing[:16]}")
        for p, n in al.refs.items():
            owners = sum(1 for pages in al.owned.values() if p in pages)
            if n != owners:
                probs.append(f"page {p}: refcount {n} != {owners} owners")
        for p in al.promoting:
            if p not in al.refs and p not in al._parked:
                probs.append(
                    f"page {p}: promoting but neither owned nor parked")
        if not self.has_work:
            if al.owned:
                probs.append(f"idle engine owns pages: {dict(al.owned)}")
            if al.promoting:
                probs.append(f"idle engine has promotions in flight: "
                             f"{dict(al.promoting)}")
            if al._parked:
                probs.append(f"idle engine has parked pages: {al._parked}")
            if self._kv_pool is not None and self._kv_pool._pinned:
                probs.append(f"idle engine holds tier pins: "
                             f"{list(self._kv_pool._pinned)}")
        return probs

    # ------------------------------------------------------------ scheduling
    def _upload_dirty(self) -> None:
        """One host->device upload of whatever changed.  Rows still mid
        chunked prefill upload as TRASH with length 0: the batched decode
        writes a token for every row, and a half-prefilled row must not
        take that write into its real pages."""
        if self._table_dirty:
            up = self._table_host.copy()
            for b, s in enumerate(self.slots):
                if s is not None and s.prefilling:
                    up[b, :] = self.trash_page
            self.cache = dataclasses.replace(self.cache, table=self._put(up))
            self._table_dirty = False
        if self._lens_dirty:
            lens = np.zeros((self.max_batch,), np.int32)
            for b, s in enumerate(self.slots):
                if s is not None and not s.prefilling:
                    lens[b] = s.seq_len
            self.cache = dataclasses.replace(self.cache,
                                             seq_lens=self._put(lens))
            self._lens_dirty = False

    def _free_slot(self) -> Optional[int]:
        for b, s in enumerate(self.slots):
            if s is None:
                return b
        return None

    def _pages_needed(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    def _admit_one(self) -> bool:
        """Admit one queued request into a free slot; True if the queue
        moved.  When the head's pages do not fit, up to
        ``ADMIT_LOOKAHEAD`` younger requests are tried instead."""
        if not self.queue:
            return False
        b = self._free_slot()
        if b is None:
            return False
        for i in range(min(len(self.queue), 1 + ADMIT_LOOKAHEAD)):
            req = self.queue[i]
            try:
                admitted = self._try_admit(b, req)
            except Exception as e:
                # _try_admit released what it took: fail THIS request
                del self.queue[i]
                self.finished[req.req_id] = RequestFailed(
                    req.req_id, "admit_exception", repr(e))
                self._newly_finished.append(req.req_id)
                return True
            if admitted:
                del self.queue[i]
                return True
        return False

    def _try_admit(self, b: int, req: Request) -> bool:
        """Admit ``req`` into slot ``b`` if its pages fit; no side effects
        when they do not.  With the prefix cache, the prompt's longest
        cached page-aligned prefix is shared into the page table (device
        pages: refcount bumps, read-only; tier entries: fresh pages filled
        by a promotion) and prefill starts at the first uncached token."""
        T = len(req.tokens)
        ps = self.page_size
        # longest cached prefix across the device index and the tier; at
        # least one prompt token always prefills (the first generated
        # token is sampled from the last prompt position's logits)
        matched: List[Tuple[str, Any]] = []
        if self._pc_on:
            if req.page_keys is None:
                req.page_keys = page_keys(req.tokens, ps)
            keys = req.page_keys[:matchable_pages(T, ps)]
            if self._kvt_on:
                matched = self.allocator.lookup_tiered(keys)
            else:
                matched = [("hbm", p) for p in self.allocator.lookup(keys)]
        cm = len(matched)
        cached = cm * ps
        hbm_pages = [p for kind, p in matched if kind == "hbm"]
        tier_keys = [k for kind, k in matched if kind == "tier"]
        bkt = self.prefill_chunk or self.prefill_bucket
        # bucket-pad the UNCACHED suffix, clamped to the table width
        end = min(cached + -(-(T - cached) // bkt) * bkt,
                  self.max_pages_per_seq * ps)
        # tier-matched spans skip prefill compute but need fresh pages for
        # the promoted payload to land in
        need = self._pages_needed(max(end, T + 1)) - cm + len(tier_keys)
        # matched warm-pool pages revive rather than consume free pages,
        # but once shared they stop being reclaimable
        pooled = sum(1 for p in hbm_pages if p in self.allocator.pool)
        if self.allocator.available - pooled < need:
            return False
        seq_id = self._seq_counter
        self._seq_counter += 1
        page_map: Dict[bytes, int] = {}
        try:
            # share BEFORE allocate: allocation pressure must never evict
            # a page this admission is about to map; the pins keep the
            # overflow from dropping the entries about to be promoted
            if tier_keys:
                self._kv_pool.pin(tier_keys)
            if hbm_pages:
                self.allocator.share(seq_id, hbm_pages)
            # batch-demote the shortfall up front: one device read for the
            # whole admission instead of one per page in _evict_one
            self._ensure_free(need)
            pages = self.allocator.allocate(seq_id, need)
            fresh = iter(pages)
            row: List[int] = []
            for kind, val in matched:
                if kind == "hbm":
                    row.append(val)
                else:
                    pg = next(fresh)
                    page_map[val] = pg
                    row.append(pg)
            suffix = list(fresh)
            self._table_host[b, :] = self.trash_page
            self._table_host[b, :cm] = row
            self._table_host[b, cm:cm + len(suffix)] = suffix
            self._table_dirty = self._lens_dirty = True
            if self._pc_on:
                if cm:
                    self.prefix_cache_hits += 1
                else:
                    self.prefix_cache_misses += 1
                self.prefix_cache_cached_tokens += cached
                self.prefix_cache_prompt_tokens += T
            promo = (self._begin_promotion(tier_keys, page_map)
                     if tier_keys else None)
            if self.prefill_chunk or cached:
                # split-fuse and/or cache hit: the uncached suffix goes
                # through continuation chunks from the first uncached
                # token; decode-ready once prefill_done reaches T
                self.slots[b] = _Slot(req=req, seq_len=cached, generated=[],
                                      seq_id=seq_id, prefill_done=cached,
                                      promo=promo)
                return True
            toks = np.zeros((1, end), np.int32)
            toks[0, :T] = req.tokens
            logits, _ = self._prefill(self.params, self._put(toks),
                                      self._view(self._table_host[b:b + 1],
                                                 0))
            slot = _Slot(req=req, seq_len=T, generated=[], seq_id=seq_id)
            self.slots[b] = slot
            # the prompt's full pages are immutable from here on (decode
            # writes only at the frontier): matchable now
            self._publish_full_pages(b, slot, upto=T)
            # the first generated token comes from the REAL last prompt
            # position, sampled in the step's one batched boundary flush
            self._queue_boundary(b, logits[0, T - 1], slot)
            return True
        except BaseException:
            # between allocation and slot publish nothing may leak: cancel
            # any begun promotion, drop the pins, release every page this
            # sequence took (shared and fresh) and clear the row
            for pg in page_map.values():
                self.allocator.cancel_promotion(pg)
            if tier_keys:
                self._kv_pool.unpin(tier_keys)
            self.allocator.release(seq_id)
            self._table_host[b, :] = self.trash_page
            self._table_dirty = self._lens_dirty = True
            self.slots[b] = None
            self._pending_boundary = [p for p in self._pending_boundary
                                      if p[0] != b]
            raise

    def _valid_tokens(self, s: _Slot) -> int:
        """Positions of slot ``s`` that hold REAL written KV: mid-prefill
        the absorbed prefix; once decoding, the prompt plus every generated
        token fed back through decode (the final one never is)."""
        if s.prefilling:
            return s.prefill_done
        return len(s.req.tokens) + max(len(s.generated) - 1, 0)

    def _publish_full_pages(self, b: int, s: _Slot, upto: int) -> None:
        """Content-address every full page of slot ``b`` holding tokens
        ``0..upto-1`` (chained keys; idempotent — shared prefix pages
        dedup onto their existing index entries)."""
        if not self._pc_on:
            return
        ps = self.page_size
        full = min(upto, self.max_pages_per_seq * ps) // ps
        if full <= 0:
            return
        if s.req.page_keys is None:
            s.req.page_keys = []
        if len(s.req.page_keys) < full:
            extend_page_keys(s.req.page_keys, s.req.tokens + s.generated,
                             full, ps)
        for slot_idx in range(full):
            page = int(self._table_host[b, slot_idx])
            if page == self.trash_page:
                break
            if page in self.allocator.promoting:
                # the payload has not landed: finish_promotion publishes it
                continue
            self.allocator.publish(page, s.req.page_keys[slot_idx])

    # ------------------------------------------------ KV tier: promote
    def _begin_promotion(self, tier_keys: List[bytes],
                         page_map: Dict[bytes, int]) -> _Promotion:
        """Start streaming a tier-matched span back into the fresh pages
        just allocated for it: quarantine them, and submit the reader's
        group-0 reads now (admission time).  The uploads happen in
        :meth:`_complete_promotion`, batched per group."""
        from deepspeed_tpu_torch.param_stream import TierPageReader

        for key, pg in page_map.items():
            self.allocator.begin_promotion(pg, key)
        reader = TierPageReader(
            self._kv_pool.host_view(), tier_keys, to_device=None,
            group_pages=self.kv_tier.promote_group_pages,
            retries=self.kv_tier.io_retries,
            retry_backoff_s=self.kv_tier.io_retry_backoff_s)
        # bound late: the callback needs the reader's own group table.
        # Weakly, as the allocator's demote hook: the reader holds the
        # callback, and engine -> slot -> reader -> engine is a cycle
        promote = _weak_method(self._promote_group)
        group_keys = _weak_method(reader.group_keys)
        reader.to_device = lambda bufs, g: promote(page_map, bufs,
                                                   group_keys(g))
        promo = _Promotion(keys=list(tier_keys), page_map=page_map,
                           reader=reader)
        promo.primed = reader.presubmit(0)
        return promo

    def _promotion_ready(self, b: int, s: _Slot) -> bool:
        """Gate for the promoting slot's prefill: defer (bounded by
        ``_KV_PROMO_DEFER_CAP``) while its tier reads are still in flight,
        so the promotion hides under the other slots' compute; then drain
        the promotion and let prefill proceed."""
        p = s.promo
        if p.reader.tier.reads_pending() and \
                p.deferred < _KV_PROMO_DEFER_CAP:
            p.deferred += 1
            self.kv_tier_promote_deferrals += 1
            return False
        self._complete_promotion(b, s)
        return True

    def _complete_promotion(self, b: int, s: _Slot) -> None:
        """Drain the slot's promotion: every group fences, decodes and
        scatters into its target pages, which then publish under their
        content keys.  Whatever escapes the reader's retries (a checksum
        mismatch, an unrecoverable read) abandons the promotion and falls
        back to re-prefilling the unlanded span."""
        p = s.promo
        try:
            for _ in p.reader.sweep(range(p.reader.n_groups),
                                    primed=p.primed):
                pass
        except Exception as e:
            self._promotion_fallback(b, s, e)
            return
        self._kvt_fault_streak = 0
        self._kv_pool.unpin(p.keys)
        s.promo = None

    def _promotion_fallback(self, b: int, s: _Slot,
                            exc: BaseException) -> None:
        """Abandon a failed promotion and re-prefill the span it was to
        stream.  Groups land in page order, so the landed (published)
        pages form a prefix; from the first unlanded page on, the
        quarantine is cancelled (the pages stay owned: prefill writes them
        now), the suspect tier entries drop, and the slot's absorbed prefix
        retreats to that page's boundary.  Repeated failures trip the
        tier's circuit breaker (``kv_tier.disable_after``)."""
        p = s.promo
        unlanded = [(key, pg) for key, pg in p.page_map.items()
                    if pg in self.allocator.promoting]
        self._kv_pool.unpin(p.keys)
        for key, pg in unlanded:
            self.allocator.cancel_promotion(pg)
            # the payload is suspect: a future admission must re-prefill
            # it — unless a concurrent promotion still pins the key (it
            # will hit the same checksum and run its own fallback)
            if key not in self._kv_pool._pinned:
                self._kv_pool.discard(key)
        if unlanded:
            row = [int(x) for x in self._table_host[b]]
            first_bad = min(row.index(pg) for _k, pg in unlanded)
            fb_tokens = first_bad * self.page_size
            s.prefill_done = min(s.prefill_done, fb_tokens)
            s.seq_len = min(s.seq_len, fb_tokens)
        else:
            fb_tokens = s.prefill_done
        if isinstance(exc, ChecksumError):
            self.kv_tier_checksum_failures += 1
        self.kv_tier_fallback_events += 1
        self.kv_tier_fallback_pages += len(unlanded)
        logger.warning(
            "serving: KV-tier promotion failed for request %r (%s): "
            "re-prefilling %d pages from token %d", s.req.req_id, exc,
            len(unlanded), fb_tokens)
        s.promo = None
        self._kvt_fault_streak += 1
        da = self.kv_tier.disable_after
        if da and self._kvt_fault_streak >= da and \
                self._kv_pool.disabled is None:
            self._kv_pool.disable(
                f"{self._kvt_fault_streak} consecutive promotion failures")

    def _promote_group(self, page_map: Dict[bytes, int], bufs,
                       g_keys) -> List[int]:
        """TierPageReader ``to_device``: one fenced GROUP of demoted pages
        -> decode (checksum first) -> one batched scatter into the target
        pages -> publish.  Int8-resident: the entries' codes and scales
        land verbatim, with no dequantisation."""
        pages, parts, i = [], [], 0
        for key in g_keys:
            n = len(self._kv_pool.entry_meta(key)[0])
            take = bufs[i:i + n]
            i += n
            parts.append(self._kv_pool.decode_quantized(key, take)
                         if self._quant_resident
                         else self._kv_pool.decode(key, take))
            pages.append(page_map[key])
        self._upload_promoted(pages, *(np.stack(c, axis=2)
                                       for c in zip(*parts)))
        if self._quant_resident:
            self.kv_tier_quant_resident_promotes += len(g_keys)
        for key, pg in zip(g_keys, pages):
            self.allocator.finish_promotion(pg, key)
        return pages

    def _cancel_promotion(self, s: _Slot) -> None:
        """Abandon a slot's in-flight promotion (preemption): release the
        quarantine and the pins; the pages free through the normal release
        path, and the tier entries stay for the requeued request."""
        p = s.promo
        if p is None:
            return
        for pg in p.page_map.values():
            self.allocator.cancel_promotion(pg)
        self._kv_pool.unpin(p.keys)
        s.promo = None

    # ------------------------------------------------- KV tier: demote
    def _planes(self):
        c = self.cache
        return ((c.k, c.k_scale, c.v, c.v_scale) if self._quant_resident
                else (c.k, c.v))

    def _fetch_pages_host(self, pages: List[int]):
        """One device -> host copy of whole pages across the layer stack,
        ``[L, KV, n, ps, d]`` per plane: (k, v), or (k codes, k scales, v
        codes, v scales) when int8-resident (verbatim: no dequantisation,
        no second rounding)."""
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        return tuple(to_host(x[:, :, idx]) for x in self._planes())

    def _upload_promoted(self, pages: List[int], *host) -> None:
        """Scatter promoted payloads (one ``[L, KV, n, ps, d]`` host array
        per plane, as :meth:`_fetch_pages_host` returns them) into their
        target pages, in place."""
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        for plane, a in zip(self._planes(), host):
            plane[:, :, idx] = from_host(a, plane.dtype).to(self.device)

    def _demote_for_evict(self, page: int, key: bytes) -> bool:
        """``PageAllocator.demote_hook``: capture an evicted warm page to
        the tier.  A span whose payload is already held re-demotes for
        free (no device read)."""
        pool = self._kv_pool
        if pool.has(key):
            pool.touch(key)
            return True
        page_planes = [a[:, :, 0] for a in self._fetch_pages_host([page])]
        loc = (pool.demote_prequantized(key, *page_planes)
               if self._quant_resident else pool.demote(key, *page_planes))
        return loc is not None

    def _demote_warm_batch(self, cands) -> None:
        """Demote a batch of warm ``(page, key)`` candidates with ONE
        batched device -> host read (spans already held just refresh their
        age), then reclaim them to the free list."""
        pool = self._kv_pool
        fresh = [(p, k) for p, k in cands if not pool.has(k)]
        if fresh:
            bufs = self._fetch_pages_host([p for p, _ in fresh])
        at = {p: i for i, (p, _) in enumerate(fresh)}
        demoted, dropped = [], []
        for p, key in cands:
            if p in at:
                page = [a[:, :, at[p]] for a in bufs]
                loc = (pool.demote_prequantized(key, *page)
                       if self._quant_resident else pool.demote(key, *page))
            else:
                loc = pool.touch(key)
            (demoted if loc else dropped).append(p)
        self.allocator.reclaim_warm(demoted, demoted=True)
        self.allocator.reclaim_warm(dropped, demoted=False)

    def _ensure_free(self, n: int) -> None:
        """Top the free list up to ``n`` pages by batch-demoting the oldest
        warm pages BEFORE an allocation dips into the warm pool."""
        if not self._kvt_on:
            return
        short = n - len(self.allocator.free)
        if short > 0:
            cands = self.allocator.oldest_warm(short)
            if cands:
                self._demote_warm_batch(cands)

    def _demote_watermark_sweep(self) -> None:
        """Proactive demotion: past the ``demote_watermark`` fraction of
        the warm-pool cap, the oldest warm pages demote in one batched
        read, freeing pages ahead of allocation pressure."""
        excess = len(self.allocator.pool) - self._kvt_wm_pages
        if excess > 0:
            self._demote_warm_batch(self.allocator.oldest_warm(excess))

    def _advance_prefill(self, b: int, s: _Slot) -> None:
        """Absorb the next chunk of slot ``b``'s prompt (one continuation
        forward over history + chunk): ``prefill_chunk`` tokens under
        split-fuse, ``prefill_bucket`` for a cache-hit admission without
        it.  A slot with an in-flight promotion first waits for its pages
        (the chunk attends over them).  On the final chunk, queue the first
        generated token from the last REAL prompt position, publish the
        prompt's pages and flip the slot decode-ready."""
        if s.promo is not None and not self._promotion_ready(b, s):
            return
        C = self.prefill_chunk or self.prefill_bucket
        T = len(s.req.tokens)
        done = s.prefill_done
        take = min(C, T - done)
        toks = np.zeros((1, C), np.int32)
        toks[0, :take] = s.req.tokens[done:done + take]
        # the view table covers the live history only (power-of-two page
        # count), so a chunk costs O(done + C) rather than O(max_seq)
        np_live = -(-(done + C) // self.page_size)
        np_bkt = 1
        while np_bkt < np_live:
            np_bkt *= 2
        np_bkt = min(np_bkt, self.max_pages_per_seq)
        logits, _ = self._chunk_prefill(
            self.params, self._put(toks),
            self._view(self._table_host[b:b + 1, :np_bkt], done))
        s.prefill_done = done + take
        s.seq_len = s.prefill_done
        self.prefill_chunks += 1
        if s.prefill_done >= T:
            s.prefill_done = -1
            # decode-ready: the device row flips from trash to real pages
            self._table_dirty = self._lens_dirty = True
            self._publish_full_pages(b, s, upto=T)
            self._queue_boundary(b, logits[0, take - 1], s)

    def _release_slot(self, b: int, s: _Slot) -> None:
        """Publish-then-release: the slot's full pages (prompt and fed-back
        generated tokens) stay matchable in the warm pool, an in-flight
        promotion is abandoned, and the slot's references drop."""
        self._publish_full_pages(b, s, upto=self._valid_tokens(s))
        if s.promo is not None:
            self._cancel_promotion(s)
        self.allocator.release(s.seq_id)
        self._table_host[b, :] = self.trash_page
        self._table_dirty = self._lens_dirty = True
        self.slots[b] = None

    def _preempt_youngest(self) -> None:
        """Recompute preemption: release the slot with the fewest generated
        tokens and requeue prompt + generated as a fresh request (its
        published pages let the recompute re-hit its own prefix)."""
        cand = [(len(s.generated), b) for b, s in enumerate(self.slots)
                if s is not None]
        if not cand:
            raise MemoryError("out of KV pages with no slot to preempt")
        _, b = min(cand)
        s = self.slots[b]
        self._release_slot(b, s)
        self._pending_boundary = [p for p in self._pending_boundary
                                  if p[0] != b]
        req = s.req
        # the finished output is tokens + generated of the FINAL
        # incarnation, which already holds everything produced before
        self.queue.appendleft(Request(
            req.req_id, req.tokens + s.generated,
            req.max_new_tokens - len(s.generated), req.temperature,
            page_keys=req.page_keys))
        self.preempted += 1

    def _queue_boundary(self, b: int, logits_row: torch.Tensor,
                        slot: _Slot) -> None:
        self._pending_boundary.append((b, logits_row,
                                       slot.req.temperature))

    def _flush_boundary(self) -> None:
        """Sample every pending prefill-boundary token in one batched
        call and one device->host fetch."""
        if not self._pending_boundary:
            return
        pend, self._pending_boundary = self._pending_boundary, []
        rows = torch.stack([p[1] for p in pend])
        temps = np.asarray([p[2] for p in pend], np.float32)
        toks = self._sample_fn(rows, temps, self.generator).cpu().numpy()
        for (b, _, _), tok in zip(pend, toks):
            self._append_token(b, int(tok))

    def _append_token(self, b: int, tok: int) -> None:
        s = self.slots[b]
        s.generated.append(tok)
        done = (self.eos is not None and tok == self.eos) or \
            len(s.generated) >= s.req.max_new_tokens
        if done:
            self.finished[s.req.req_id] = list(s.req.tokens) + s.generated
            self._newly_finished.append(s.req.req_id)
            self._release_slot(b, s)

    def _grow_pages(self, ahead: int = 1) -> None:
        """Before decode writes: map every page the next ``ahead`` token
        positions will touch; preempt when the pool is dry.  Positions past
        the request's lifetime are not provisioned (their writes land on
        the trash page)."""
        ps = self.page_size
        for b, s in enumerate(self.slots):
            if s is None or s.prefilling:
                continue
            lifetime = len(s.req.tokens) + s.req.max_new_tokens
            # the last KV write is at lifetime-2: the final generated token
            # is appended to the output but never fed back through decode
            last_pos = min(s.seq_len + ahead - 1, lifetime - 2,
                           self.max_pages_per_seq * ps - 1)
            for slot_idx in range(s.seq_len // ps, last_pos // ps + 1):
                if self._table_host[b, slot_idx] != self.trash_page:
                    continue
                # available counts the warm pool: allocate reclaims cached
                # pages before any preemption is considered
                while not self.allocator.available:
                    self._preempt_youngest()
                    if self.slots[b] is None:   # preempted ourselves
                        break
                if self.slots[b] is None:
                    break
                self._ensure_free(1)
                pg = self.allocator.allocate(s.seq_id, 1)[0]
                self._table_host[b, slot_idx] = pg
                self._table_dirty = True

    # ------------------------------------------------------------------ step
    def step(self) -> List[Any]:
        """One scheduling iteration: watermark demotion -> admit -> prefill
        chunks -> boundary sampling -> batched decode.  Returns the request
        ids that finished during this step."""
        self._newly_finished = []
        if self._kvt_wm_pages is not None:
            # BEFORE admission: demoting past the watermark frees pages
            # the admissions below can use
            self._demote_watermark_sweep()
        while self._admit_one():
            pass
        for b, s in list(enumerate(self.slots)):
            if s is not None and s.prefilling:
                self._advance_prefill(b, s)
        self._flush_boundary()
        ready = lambda: [(b, s) for b, s in enumerate(self.slots)  # noqa: E731
                         if s is not None and not s.prefilling]
        active = ready()
        if active:
            self._grow_pages(ahead=self.decode_chunk)
            active = ready()
        if active:
            self._decode_active(active)
        return list(self._newly_finished)

    def _decode_active(self, active) -> None:
        """K = ``decode_chunk`` decode steps for every row in one device
        sweep: each sampled token feeds the next step on the device, and
        the host reads the [B, K] tokens once."""
        K = self.decode_chunk
        self._upload_dirty()
        toks = np.zeros((self.max_batch, 1), np.int32)
        temps = np.zeros((self.max_batch,), np.float32)
        for b, s in active:
            toks[b, 0] = s.generated[-1] if s.generated else s.req.tokens[-1]
            temps[b] = s.req.temperature
        tok = self._put(toks)
        cache = self.cache
        out = []
        for _ in range(K):
            logits, cache = self._decode(self.params, tok, cache)
            nxt = self._sample_fn(logits[:, -1], temps, self.generator)
            out.append(nxt)
            tok = nxt[:, None]
        self.cache = cache
        # the device's structural seq_lens + K is trusted until the next
        # composition change re-uploads it
        for b, s in active:
            s.seq_len += K
        self.decode_steps += K
        host_toks = torch.stack(out, dim=1).cpu().numpy()      # [B, K]
        for b, s in active:
            for j in range(K):
                self._append_token(b, int(host_toks[b, j]))
                if self.slots[b] is None:       # finished mid-chunk: the
                    break                       # rest is discarded

    def run(self, max_steps: int = 10_000) -> Dict[Any, RequestResult]:
        """Drive until every submitted request completes."""
        steps = 0
        while self.has_work:
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError("serving loop did not converge")
        return dict(self.finished)

    def drain_finished(self) -> Dict[Any, RequestResult]:
        """Hand over and forget completed outputs."""
        out, self.finished = self.finished, {}
        return out

    def shutdown(self) -> None:
        """Idempotent: later ``submit`` calls raise :class:`EngineClosed`."""
        self._closed = True


def _family_engine(forward_paged, params, cfg, weight_dtype: str,
                   quant_group_size: int, device, skip_paths,
                   **kw) -> ServingEngine:
    """ServingEngine over a model family's ``forward_paged``: ``params``
    move to ``device``, the kernel policy resolves once and reaches the
    engine, and ``weight_dtype="int8"`` quantizes every matrix leaf but
    ``skip_paths`` on ``device`` (B9 on CUDA; leaves already quantized pass
    through).  Any other ``weight_dtype`` but ``"bfloat16"`` raises
    ``NotImplementedError``: never serve unquantized quietly."""
    dev = resolve_device(device)
    policy = resolve_serving_kernels(kw.pop("kernels", None), device=dev)
    pk = policy.paged_attention
    params = _to_device(params, dev)
    if weight_dtype != "bfloat16":
        params, = quantize_for_inference(
            params, weight_dtype=weight_dtype, group_size=quant_group_size,
            skip_paths=skip_paths)

    def step(params, tokens, cache):
        return forward_paged(params, tokens, cfg, cache, paged_kernel=pk)

    def chunk_step(params, tokens, cache):
        return forward_paged(params, tokens, cfg, cache, continuation=True,
                             paged_kernel=pk)

    return ServingEngine(
        params, step, step, n_layers=cfg.n_layers, n_kv=cfg.n_kv_heads,
        head_dim=cfg.head_dim, chunk_prefill_fn=chunk_step, kernels=policy,
        device=dev, **kw)


def llama_serving_engine(params, cfg, weight_dtype: str = "bfloat16",
                         quant_group_size: int = 128, device=None,
                         **kw) -> ServingEngine:
    """ServingEngine over :func:`~deepspeed_tpu_torch.models.llama.
    forward_paged`.  ``params`` (the JAX pytree layout, see
    :mod:`deepspeed_tpu_torch.weights`) move to ``device`` (None = CUDA).

    ``weight_dtype="int8"``: weight-only int8 (ref: ``init_inference(dtype=
    int8)``): every matrix leaf is quantized on ``device`` in groups of
    ``quant_group_size`` (kernel B9 on CUDA; the stacked ``[L, d]`` norm
    gains stay exact, as the JAX builder keeps them), and the forward
    dequantizes one layer at a time."""
    from deepspeed_tpu_torch.models import llama

    return _family_engine(llama.forward_paged, params, cfg, weight_dtype,
                          quant_group_size, device,
                          ("attn_norm", "mlp_norm", "final_norm"), **kw)


# GPT-2 leaves an int8 engine keeps exact (the JAX builder's list): the
# stacked biases and LayerNorm vectors and the position table
GPT2_INT8_SKIP = ("ln1_w", "ln1_b", "ln2_w", "ln2_b", "qkv_b", "proj_b",
                  "fc_b", "out_b", "lnf_w", "lnf_b", "wpe")


def gpt2_serving_engine(params, cfg, weight_dtype: str = "bfloat16",
                        quant_group_size: int = 128, device=None,
                        **kw) -> ServingEngine:
    """ServingEngine over :func:`~deepspeed_tpu_torch.models.gpt2.
    forward_paged` (ref: the reference serves GPT-2 through kernel
    injection, deepspeed/module_inject/containers/gpt2.py).  ``max_seq``
    past the learned position table raises ``ValueError``; int8 weights
    keep :data:`GPT2_INT8_SKIP` exact; a ``mesh`` is refused by the engine,
    as for Llama."""
    from deepspeed_tpu_torch.models import gpt2

    max_seq = kw.get("max_seq", 256)
    if max_seq > cfg.max_seq_len:
        # learned positions are HARD-bounded by the wpe table (unlike
        # RoPE); past it the forward's clamp would silently reuse the
        # last position embedding
        raise ValueError(
            f"max_seq {max_seq} exceeds the learned position table "
            f"(cfg.max_seq_len={cfg.max_seq_len})")
    return _family_engine(gpt2.forward_paged, params, cfg, weight_dtype,
                          quant_group_size, device, GPT2_INT8_SKIP, **kw)


# Mixtral leaves an int8 engine keeps exact (the JAX engine's list): the
# router (int8 gate logits could flip a near-tied top-k choice) and the
# stacked norm gains
MIXTRAL_INT8_SKIP = ("gate", "attn_norm", "mlp_norm", "final_norm")


def mixtral_serving_engine(params, cfg, weight_dtype: str = "bfloat16",
                           quant_group_size: int = 128, device=None,
                           zero_inference=None, **kw) -> ServingEngine:
    """ServingEngine over :func:`~deepspeed_tpu_torch.models.mixtral.
    forward_paged` (ref: DeepSpeed-MoE inference serving): iteration-level
    scheduling, paged KV, split-fuse and decode chunks apply to the MoE
    model unchanged.  int8 weights keep :data:`MIXTRAL_INT8_SKIP` exact;
    leaves already quantized (``weights.init_quantized_params``, for a
    model whose bf16 weights do not fit the card) pass through.  A
    ``mesh`` (expert parallelism) is refused by the engine, as for Llama;
    ``zero_inference`` (streaming the expert stacks from host memory)
    raises ``NotImplementedError`` naming ROADMAP A8."""
    from deepspeed_tpu_torch.models import mixtral

    if _enabled(zero_inference):
        raise NotImplementedError(
            "mixtral_serving_engine(zero_inference=...): weight-streamed "
            "MoE serving needs inference/zero_inference.py and "
            "mixtral.paged_layered_fns (ROADMAP A8)")
    return _family_engine(mixtral.forward_paged, params, cfg, weight_dtype,
                          quant_group_size, device, MIXTRAL_INT8_SKIP, **kw)


def _to_device(tree, dev):
    return tree_map(lambda t: t.to(dev), tree)


def serving_engine(params, cfg, **kw):
    """Model registry for serving: dispatch on the config type (Mixtral
    first, as in the JAX registry, then Llama and GPT-2; the other
    families come with later slices)."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    from deepspeed_tpu_torch.models.mixtral import MixtralConfig

    if isinstance(cfg, MixtralConfig):
        return mixtral_serving_engine(params, cfg, **kw)
    if isinstance(cfg, LlamaConfig):
        return llama_serving_engine(params, cfg, **kw)
    if isinstance(cfg, GPT2Config):
        return gpt2_serving_engine(params, cfg, **kw)
    raise NotImplementedError(
        f"no serving path for {type(cfg).__name__} in deepspeed_tpu_torch "
        "yet; the other model families come with a later slice")
