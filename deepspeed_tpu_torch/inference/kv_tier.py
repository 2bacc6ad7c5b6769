"""Tiered KV cache: the host and NVMe pools for demoted prefix-cache pages
(port of ``deepspeed_tpu/inference/kv_tier.py``; ref: ZeRO-Infinity
tiering, arXiv:2104.07857, and ZeRO-Offload host staging,
arXiv:2101.06840).

The paged prefix cache keeps published refcount-0 pages warm on the device
until allocation pressure reclaims them; without a tier, reclaim means DROP
and the next prompt matching that span pays a full re-prefill.
:class:`KVTierPool` gives the allocator somewhere cheaper to put cold
pages:

    device warm pool ──demote──▶ host pool ──spill──▶ NVMe ──▶ drop
            ▲                                  │
            └──────────── promote ◀────────────┘

- **Demote** (eviction pressure or the ``demote_watermark`` sweep): the
  page's KV — one ``[L, KV, ps, Dh]`` array pair across the layer stack —
  is copied device -> host and indexed under its content key.
  ``quantize_cold`` stores int8 codes + per-token-row f32 scales (~2x the
  pages per byte); off by default, keeping the tier bit-exact.
- **Spill**: past ``host_pool_bytes`` the OLDEST unpinned host entries
  cascade to per-page files under ``nvme_dir``, written through the
  port's aio pool (:mod:`~deepspeed_tpu_torch.io.aio`); with no
  ``nvme_dir`` (or past ``nvme_pool_bytes``) the oldest entries drop.
- **Promote**: an admission matching a demoted span allocates fresh device
  pages and streams the payload back through
  :class:`~deepspeed_tpu_torch.param_stream.TierPageReader`; the pool
  implements its read interface (``get_submit`` / ``reads_pending`` /
  ``fence_reads`` / ``next_read_slot``), serving host entries as zero-copy
  arrays and NVMe entries as alternating-slot aio reads, so a promotion's
  group ``g + 1`` reads overlap group ``g``'s upload.  One NVMe-backed
  promotion streams at a time (the engine serializes them); host-resident
  promotions read through :meth:`KVTierPool.host_view` without the
  channel.

Host payloads are numpy arrays in the page's host form: numpy has no
bfloat16, so a bf16 page travels as its raw 16-bit pattern (``int16``)
while the entry records dtype ``"bfloat16"``; the crc32 runs over those
bytes.  Int8 codes and f32 scales are plain numpy.

Quantisation error contract (``quantize_cold``): symmetric per-row int8
over the head dim — scale = rowmax(|x|)/127, code = round(x/scale) — so
the dequantised page differs from the original by at most
``rowmax(|x|) * KV_TIER_QUANT_RTOL`` elementwise (half a quantisation
step, plus the bf16 cast the cache dtype already imposes).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import os
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch import faults as _faults
from deepspeed_tpu_torch.faults import ChecksumError, retry_with_backoff
from deepspeed_tpu_torch.inference.prefix_cache import TierEntry, key_hex

logger = logging.getLogger(__name__)

# per-element bound of the int8 cold-page codec, RELATIVE to the row's
# max |value| (the scale denominator): half a quantisation step
KV_TIER_QUANT_RTOL = 0.5 / 127.0


# ------------------------------------------------------ host page form
def dtype_name(dtype: torch.dtype) -> str:
    """``"float32"`` / ``"bfloat16"`` / ... for a torch dtype."""
    return str(dtype).replace("torch.", "")


def to_host(t: torch.Tensor) -> np.ndarray:
    """A device tensor as a host array in its host form (bf16 as its raw
    16-bit pattern, since numpy has no bfloat16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def from_host(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`to_host` (a CPU tensor of ``dtype``)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t


def _host_f32(a: np.ndarray, dtype_str: str) -> np.ndarray:
    if dtype_str == "bfloat16":
        return from_host(a, torch.bfloat16).float().numpy()
    return np.asarray(a, np.float32)


def _crc(arr: np.ndarray) -> int:
    """crc32 of an array's raw bytes (through a uint8 view: same bytes, no
    copy)."""
    return zlib.crc32(np.ascontiguousarray(arr).view(np.uint8))


# ------------------------------------------------------------ int8 codec
def quantize_page(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric int8 over the last (head) dim: x [..., Dh] float ->
    (codes int8 [..., Dh], scales f32 [..., 1]).  All-zero rows take
    scale 1.0 so the codec is exact on them."""
    x32 = np.asarray(x, np.float32)
    amax = np.abs(x32).max(axis=-1, keepdims=True)
    scale = amax / 127.0
    scale[scale == 0.0] = 1.0
    codes = np.clip(np.rint(x32 / scale), -127, 127).astype(np.int8)
    return codes, scale.astype(np.float32)


def dequantize_page(codes: np.ndarray, scale: np.ndarray,
                    dtype) -> np.ndarray:
    """Inverse of :func:`quantize_page`, cast back to the page dtype (in
    its host form)."""
    x = codes.astype(np.float32) * scale
    if dtype_name(dtype) == "bfloat16":
        return to_host(torch.from_numpy(x).to(torch.bfloat16))
    return x.astype(dtype_name(dtype))


def _entry(key: bytes, data, *, quantized: bool, page_dtype,
           tick: int) -> TierEntry:
    hexk = key_hex(key)
    data = tuple(np.ascontiguousarray(b) for b in data)
    bufs = tuple((f"kv_{hexk}_{i}", tuple(b.shape), str(b.dtype))
                 for i, b in enumerate(data))
    return TierEntry(
        key=key, location="host", quantized=quantized,
        dtype=dtype_name(page_dtype), buffers=bufs,
        nbytes=int(sum(b.nbytes for b in data)), data=data, tick=tick,
        checksums=tuple(_crc(b) for b in data))


def encode_entry(key: bytes, k: np.ndarray, v: np.ndarray, *,
                 quantize: bool, page_dtype, tick: int = 0) -> TierEntry:
    """Serialise one page's (k, v) (host form of ``page_dtype``) into a
    host-resident :class:`~deepspeed_tpu_torch.inference.prefix_cache.
    TierEntry`, with the per-buffer crc32 recorded now and verified when a
    promotion decodes the payload back."""
    if quantize:
        name = dtype_name(page_dtype)
        kq, ks = quantize_page(_host_f32(k, name))
        vq, vs = quantize_page(_host_f32(v, name))
        data = (kq, ks, vq, vs)
    else:
        data = (k, v)
    return _entry(key, data, quantized=quantize, page_dtype=page_dtype,
                  tick=tick)


def encode_prequantized_entry(key: bytes, kq: np.ndarray, ks: np.ndarray,
                              vq: np.ndarray, vs: np.ndarray, *,
                              page_dtype, tick: int = 0) -> TierEntry:
    """Serialise a page whose payload is ALREADY the int8 codec's (codes,
    scales) — the int8-resident engine demotes the device's code and scale
    planes verbatim, so no dequantise/requantise round trip touches the
    data.  Buffer naming and checksums match :func:`encode_entry`'s
    quantised layout: the two entries are interchangeable."""
    return _entry(key, (kq, ks, vq, vs), quantized=True,
                  page_dtype=page_dtype, tick=tick)


# ------------------------------------------------- NVMe read/write legs
class _KVNvmeChannel:
    """Alternating-slot aio READ channel over per-page spill files, plus a
    blocking write leg for the spill cascade.  Spill files come and go
    with cache churn, so fds open per batch and close at the fence: a
    long-lived server never holds one fd per page it ever demoted."""

    def __init__(self, path: str, n_threads: int = 4, retries: int = 2,
                 backoff_s: float = 0.05, on_retry=None):
        from deepspeed_tpu_torch.io.aio import AioHandle

        os.makedirs(path, exist_ok=True)
        self.dir = path
        self.rpools = [AioHandle(n_threads), AioHandle(n_threads)]
        self.rslot = 0
        self._rfds: List[List[int]] = [[], []]
        self._wpool = AioHandle(n_threads)
        # bounded spill-write retry: a transient aio error must not turn
        # a demotion into a dropped page on the first hiccup
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self._on_retry = on_retry

    def _path(self, name: str) -> str:
        return os.path.join(self.dir, name + ".bin")

    # ---------------------------------------------------------- reads
    def submit_read(self, name: str, buf: np.ndarray) -> None:
        pool = self.rpools[self.rslot]
        fd = pool.open(self._path(name))
        pool.pread(fd, buf, 0)
        self._rfds[self.rslot].append(fd)

    def reads_pending(self) -> int:
        return self.rpools[self.rslot].pending()

    def fence_reads(self) -> None:
        pool = self.rpools[self.rslot]
        errs = pool.wait()
        for fd in self._rfds[self.rslot]:
            pool.close(fd)
        self._rfds[self.rslot] = []
        if errs:
            raise IOError(f"{errs} KV-tier NVMe reads failed")

    def next_read_slot(self) -> None:
        self.rslot ^= 1

    def fence_all_reads(self) -> None:
        """Drain BOTH slots (a cancelled promotion: the reads target host
        buffers the caller is about to drop).  Read errors are ignored:
        every caller is abandoning the transfer."""
        for s in (0, 1):
            pool = self.rpools[s]
            pool.wait()
            for fd in self._rfds[s]:
                pool.close(fd)
            self._rfds[s] = []
        self.rslot = 0

    # --------------------------------------------------------- writes
    def write(self, name: str, buf: np.ndarray) -> None:
        """Blocking spill write (demotion is already the slow path),
        retried with backoff; the LAST failure propagates and the caller
        drops the entry instead of spilling it."""
        def attempt():
            fd = self._wpool.open(self._path(name), write=True)
            try:
                self._wpool.pwrite(fd, buf, 0)
                errs = self._wpool.wait()
            finally:
                self._wpool.close(fd)
            if errs:
                raise IOError(f"KV-tier NVMe write of {name} failed")

        retry_with_backoff(attempt, attempts=self.retries,
                           backoff_s=self.backoff_s,
                           on_retry=self._on_retry)

    def read_sync(self, name: str, shape, dtype) -> np.ndarray:
        """One spill file through the plain OS path (no aio), behind the
        ``sync_read`` injection point."""
        _faults.inject("sync_read", key=name)
        buf = np.empty(tuple(shape), np.dtype(dtype))
        with open(self._path(name), "rb") as f:
            if f.readinto(memoryview(buf.reshape(-1).view(np.uint8))) \
                    != buf.nbytes:
                raise IOError(f"short read of {self._path(name)}")
        return buf

    def unlink(self, name: str) -> None:
        try:
            os.remove(self._path(name))
        except OSError:
            pass


def _maybe_corrupt(entry: TierEntry) -> TierEntry:
    """The ``kv_corrupt`` injection point of a demote: with a firing rule,
    flip a payload byte AFTER the entry's checksum was recorded, so the
    promote-side verify must catch exactly this."""
    if _faults.active_plan() is not None:
        _delay, err = _faults.poll("kv_corrupt", key_hex(entry.key))
        if err is not None:
            _faults.corrupt_array(entry.data[0])
    return entry


class KVTierPool:
    """Host + NVMe pool for demoted KV pages, content-addressed by the same
    chained page keys as the device prefix cache.

    One pool per engine; the engine installs it as ``PageAllocator.spill``
    so the allocator's chain walk (``lookup_tiered``) treats demoted spans
    as cache hits, and as ``demote_hook`` so eviction captures the page
    instead of dropping it.  The pool is also the read backend of
    :class:`~deepspeed_tpu_torch.param_stream.TierPageReader`.

    Entries pinned via :meth:`pin` (an in-flight promotion's keys) are
    exempt from the spill/drop cascade: a concurrent demotion must not
    delete a file a promotion's reads are about to land from.
    ``page_dtype`` is the cache's torch dtype."""

    def __init__(self, cfg, page_shape: Sequence[int], page_dtype):
        self.cfg = cfg
        self.page_shape = tuple(int(s) for s in page_shape)  # (L,KV,ps,Dh)
        self.page_dtype = page_dtype
        self.entries: Dict[bytes, TierEntry] = {}
        self._tick = 0
        self.host_bytes = 0
        self.nvme_bytes = 0
        self._pinned: Dict[bytes, int] = {}   # key -> pin count
        self._n = {"host": 0, "nvme": 0}
        # age order per location, oldest first (touch() refreshes): the
        # cascade pops victims in O(pinned-skips), not O(entries)
        self._order: Dict[str, "collections.OrderedDict[bytes, None]"] = {
            "host": collections.OrderedDict(),
            "nvme": collections.OrderedDict()}
        # circuit breaker: after repeated promote failures the engine
        # calls disable() — lookups miss and demotes become evictions,
        # while entries an in-flight promotion still reads stay intact
        self.disabled: Optional[str] = None
        self.spilled_pages = 0
        self.dropped_pages = 0
        self.spill_failures = 0
        self.write_retries = 0

        def note_retry(_attempt, _err):
            self.write_retries += 1

        self._nvme: Optional[_KVNvmeChannel] = None
        if cfg.nvme_dir:
            self._nvme = _KVNvmeChannel(
                cfg.nvme_dir, n_threads=cfg.aio_threads,
                retries=cfg.io_retries, backoff_s=cfg.io_retry_backoff_s,
                on_retry=note_retry)
        # cooperative aio priority (set by the ZeRO-Inference engine when
        # KV promotion shares the disk with its layer-weight reads)
        self._prio_group = None
        self._prio = 0

    # ------------------------------------------------------- accounting
    @property
    def uses_aio(self) -> bool:
        return self._nvme is not None

    def occupancy(self) -> Dict[str, object]:
        return {"host_pages": self._n["host"],
                "host_bytes": int(self.host_bytes),
                "nvme_pages": self._n["nvme"],
                "nvme_bytes": int(self.nvme_bytes),
                "spilled_pages": int(self.spilled_pages),
                "dropped_pages": int(self.dropped_pages),
                "spill_failures": int(self.spill_failures),
                "write_retries": int(self.write_retries),
                "disabled": self.disabled}

    def disable(self, reason: str) -> None:
        """Circuit-break the tier: lookups miss (``has`` -> False) and
        demotes become plain evictions.  Idempotent."""
        if self.disabled is None:
            self.disabled = str(reason)
            logger.warning("kv_tier: tier DISABLED (%s): demotes become "
                           "evictions, tier hits become misses", reason)

    # --------------------------------------------------------- priority
    def set_priority(self, group, priority: int = 0) -> None:
        """Join an :class:`~deepspeed_tpu_torch.io.aio.AioPriorityGroup`:
        promotion submission defers while a higher-priority member (the
        ZeRO-Inference weight stream) has reads in flight."""
        self._prio_group = group
        self._prio = int(priority)
        if group is not None and self._nvme is not None:
            group.register(self._nvme.reads_pending, self._prio)

    def may_submit(self) -> bool:
        """False while a higher-priority aio user is mid-flight: the
        engine then defers the promotion's presubmit (bounded by its
        deferral cap)."""
        return self._prio_group is None or \
            not self._prio_group.busy_above(self._prio)

    # ------------------------------------------------------------ index
    def has(self, key: bytes) -> bool:
        return self.disabled is None and key in self.entries

    def location(self, key: bytes) -> Optional[str]:
        e = self.entries.get(key)
        return e.location if e is not None else None

    def touch(self, key: bytes) -> Optional[str]:
        """Refresh an entry's cascade age (re-demoting a span whose payload
        is still held is free: no copy, no write)."""
        e = self.entries.get(key)
        if e is None:
            return None
        self._tick += 1
        e.tick = self._tick
        self._order[e.location].move_to_end(key)
        return e.location

    def pin(self, keys) -> None:
        """Refcounted: two concurrent promotions sharing a key must BOTH
        finish before the overflow may drop it."""
        for k in keys:
            self._pinned[k] = self._pinned.get(k, 0) + 1

    def unpin(self, keys) -> None:
        for k in keys:
            n = self._pinned.get(k, 0) - 1
            if n <= 0:
                self._pinned.pop(k, None)
            else:
                self._pinned[k] = n

    # ----------------------------------------------------------- demote
    def demote(self, key: bytes, k: np.ndarray,
               v: np.ndarray) -> Optional[str]:
        """Capture one page's KV (``k``/``v``: [L, KV, ps, Dh] in the
        cache dtype's host form) under ``key``; returns the landing tier,
        or None when nothing could hold it (a plain eviction).  A key
        already held just refreshes its age."""
        if self.disabled is not None:
            return None
        if key in self.entries:
            return self.touch(key)
        self._tick += 1
        return self._land(_maybe_corrupt(encode_entry(
            key, k, v, quantize=self.cfg.quantize_cold,
            page_dtype=self.page_dtype, tick=self._tick)))

    def demote_prequantized(self, key: bytes, kq: np.ndarray,
                            ks: np.ndarray, vq: np.ndarray,
                            vs: np.ndarray) -> Optional[str]:
        """Capture one ALREADY-QUANTISED page (``kq``/``vq`` int8 codes
        [L, KV, ps, Dh], ``ks``/``vs`` f32 scales [L, KV, ps, 1]) — the
        int8-resident engine's demote.  Same landing semantics; requires
        ``quantize_cold``."""
        if self.disabled is not None:
            return None
        if key in self.entries:
            return self.touch(key)
        if not self.cfg.quantize_cold:
            raise ValueError(
                "demote_prequantized requires kv_tier.quantize_cold: a "
                "dense-entry pool cannot hold int8 codec payloads")
        self._tick += 1
        return self._land(_maybe_corrupt(encode_prequantized_entry(
            key, kq, ks, vq, vs, page_dtype=self.page_dtype,
            tick=self._tick)))

    def admit_entry(self, entry: TierEntry) -> Optional[str]:
        """Admit an ALREADY-SERIALISED entry (a fabric migration: another
        replica encoded and checksummed the payload; int8 cold pages ride
        as they are).  Record and payload are copied, so this pool never
        aliases a shared transit buffer.  Returns the landing tier as
        :meth:`demote` does; the original checksums carry over, so a
        payload corrupted in transit fails this pool's promotion-time
        verify and the admitting engine re-prefills."""
        if self.disabled is not None:
            return None
        if entry.key in self.entries:
            return self.touch(entry.key)
        self._tick += 1
        return self._land(dataclasses.replace(
            entry, location="host", tick=self._tick,
            data=tuple(np.array(b, copy=True) for b in entry.data)))

    def entry_payload(self, key: bytes) -> TierEntry:
        """A host-form view of one entry for export: a host entry returns
        as it is; an NVMe entry's buffers are read back synchronously (an
        export is off the decode path).  The ORIGINAL checksums ride
        along, for the importer's decode to verify."""
        e = self.entries[key]
        if e.location == "host":
            return e
        bufs = tuple(self._nvme.read_sync(name, shape, dtype)
                     for name, shape, dtype in e.buffers)
        return dataclasses.replace(e, location="host", data=bufs)

    def _land(self, entry: TierEntry) -> Optional[str]:
        """Place a freshly encoded entry: host pool first, cascading older
        entries down (host -> NVMe -> drop) to make room; an entry bigger
        than the whole host pool goes straight to NVMe."""
        if entry.nbytes > self.cfg.host_pool_bytes:
            if self._spill_entry(entry, accounted=False):
                self.entries[entry.key] = entry
                return entry.location
            self.dropped_pages += 1
            return None
        while self.host_bytes + entry.nbytes > self.cfg.host_pool_bytes:
            if not self._cascade_one():   # only pinned entries left
                self.dropped_pages += 1
                return None
        self.entries[entry.key] = entry
        self.host_bytes += entry.nbytes
        self._n["host"] += 1
        self._order["host"][entry.key] = None
        return "host"

    def _oldest(self, location: str) -> Optional[TierEntry]:
        for key in self._order[location]:
            if key not in self._pinned:
                return self.entries[key]
        return None

    def _cascade_one(self) -> bool:
        """Push the oldest unpinned host entry down one tier (NVMe when
        configured, else drop).  False when the host pool holds only
        pinned entries."""
        victim = self._oldest("host")
        if victim is None:
            return False
        if not self._spill_entry(victim):
            self._discard(victim, count_drop=True)
        return True

    def _spill_entry(self, e: TierEntry, accounted: bool = True) -> bool:
        """Write ``e``'s payload to NVMe files and retag it.
        ``accounted=False`` for an entry that never entered the host pool
        (the direct-to-NVMe path of an oversized entry)."""
        if self._nvme is None:
            return False
        cap = self.cfg.nvme_pool_bytes
        while cap is not None and self.nvme_bytes + e.nbytes > cap:
            old = self._oldest("nvme")
            if old is None:
                return False
            self._discard(old, count_drop=True)
        try:
            for (name, _s, _d), buf in zip(e.buffers, e.data):
                self._nvme.write(name, buf)
        except (IOError, OSError):
            # retries exhausted: unlink any partial files (a later
            # same-key spill must not find a torn payload) and drop
            for name in e.names:
                self._nvme.unlink(name)
            self.spill_failures += 1
            logger.warning("kv_tier: spill write of %s failed after "
                           "retries: dropping the entry",
                           key_hex(e.key)[:12])
            return False
        if accounted:
            self.host_bytes -= e.nbytes
            self._n["host"] -= 1
            self._order["host"].pop(e.key, None)
        e.location = "nvme"
        e.data = None
        self.nvme_bytes += e.nbytes
        self._n["nvme"] += 1
        self._order["nvme"][e.key] = None
        self.spilled_pages += 1
        return True

    def _discard(self, e: TierEntry, count_drop: bool = False) -> None:
        self.entries.pop(e.key, None)
        self._order[e.location].pop(e.key, None)
        self._n[e.location] -= 1
        if e.location == "host":
            self.host_bytes -= e.nbytes
        else:
            self.nvme_bytes -= e.nbytes
            for name in e.names:
                self._nvme.unlink(name)
        if count_drop:
            self.dropped_pages += 1

    def discard(self, key: bytes) -> None:
        e = self.entries.get(key)
        if e is not None:
            self._discard(e)

    def host_view(self) -> "_HostOnlyView":
        """A channel-free read view for promotions whose keys are all
        host-resident (pinned, so they cannot spill mid-flight): no-op
        fencing, so any number of them run concurrently without touching
        the NVMe channel another promotion may own."""
        return _HostOnlyView(self)

    # ------------------------------------------ read interface (promote)
    def entry_meta(self, key: bytes):
        """(names, shapes, dtypes) of ``key``'s buffers — the read plan a
        TierPageReader submits."""
        e = self.entries[key]
        return (list(e.names), [b[1] for b in e.buffers],
                [b[2] for b in e.buffers])

    def _entry_of(self, name: str) -> Tuple[TierEntry, int]:
        hexk, i = name[len("kv_"):].rsplit("_", 1)
        return self.entries[bytes.fromhex(hexk)], int(i)

    def _host_buffer(self, name: str) -> np.ndarray:
        """``name`` strictly from host storage (the channel-free view's
        read path: an NVMe entry here means a pin failed to hold it
        host-resident, which must fail loudly rather than fence a channel
        this promotion does not own)."""
        e, i = self._entry_of(name)
        if e.location != "host":
            raise RuntimeError(f"channel-free promotion read of {name} "
                               f"found the entry on {e.location!r}")
        return e.data[i]

    def get_submit(self, name: str, shape, dtype, out=None):
        e, i = self._entry_of(name)
        if e.location == "host":
            # zero-copy: the stored array IS the fenced buffer
            return e.data[i]
        buf = np.empty(tuple(shape), np.dtype(dtype)) if out is None \
            else out
        self._nvme.submit_read(name, buf)
        return buf

    def read_sync(self, name: str, shape, dtype) -> np.ndarray:
        """Synchronous read of one buffer, the rung below the aio channel:
        host entries return their array, NVMe entries read their file
        through the plain OS path.  Carries the ``sync_read`` injection
        point, so a test can exhaust the last rung."""
        e, i = self._entry_of(name)
        if e.location == "host":
            _faults.inject("sync_read", key=name)
            return e.data[i]
        return self._nvme.read_sync(name, shape, dtype)

    def reads_pending(self) -> int:
        return self._nvme.reads_pending() if self._nvme is not None else 0

    def fence_reads(self) -> None:
        if self._nvme is not None:
            self._nvme.fence_reads()

    def next_read_slot(self) -> None:
        if self._nvme is not None:
            self._nvme.next_read_slot()

    def fence_all_reads(self) -> None:
        if self._nvme is not None:
            self._nvme.fence_all_reads()

    # ----------------------------------------------------------- decode
    def _verify(self, key: bytes, e: TierEntry, bufs) -> None:
        """Check every fenced buffer against the checksum recorded at
        demote time: a corrupt payload raises :class:`~deepspeed_tpu_torch.
        faults.ChecksumError` BEFORE anything reaches device pages."""
        if e.checksums is None:
            return
        for (name, _s, _d), buf, want in zip(e.buffers, bufs,
                                             e.checksums):
            got = _crc(buf)
            if got != want:
                raise ChecksumError(
                    f"KV-tier page {key_hex(key)[:12]} buffer {name}: "
                    f"payload checksum mismatch ({got:#x} != {want:#x}): "
                    "the host copy is corrupt")

    def decode(self, key: bytes, bufs) -> Tuple[np.ndarray, np.ndarray]:
        """Fenced buffers -> the page's (k, v) in the cache dtype's host
        form (dequantising cold pages).  Checksum-verified FIRST."""
        e = self.entries[key]
        self._verify(key, e, bufs)
        if e.quantized:
            kq, ks, vq, vs = bufs
            return (dequantize_page(kq, ks, self.page_dtype),
                    dequantize_page(vq, vs, self.page_dtype))
        k, v = bufs
        return np.asarray(k), np.asarray(v)

    def decode_quantized(self, key: bytes, bufs):
        """Fenced buffers -> the page's RAW int8 codec form ``(kq, ks, vq,
        vs)``, checksum-verified first: the int8-resident promotion
        scatters these straight into the device's code and scale planes.
        Raises on a dense entry (there are no codes to publish)."""
        e = self.entries[key]
        if not e.quantized:
            raise ValueError(
                f"KV-tier page {key_hex(key)[:12]} is a dense entry: "
                "int8-resident promotion needs kv_tier.quantize_cold "
                "payloads")
        self._verify(key, e, bufs)
        kq, ks, vq, vs = bufs
        return (np.asarray(kq, np.int8), np.asarray(ks, np.float32),
                np.asarray(vq, np.int8), np.asarray(vs, np.float32))


class _HostOnlyView:
    """Channel-free read facade over a :class:`KVTierPool`: host-array
    reads with no-op fencing."""

    def __init__(self, pool: KVTierPool):
        self._pool = pool

    def entry_meta(self, key: bytes):
        return self._pool.entry_meta(key)

    def get_submit(self, name: str, shape, dtype, out=None):
        return self._pool._host_buffer(name)

    def read_sync(self, name: str, shape, dtype):
        return self._pool.read_sync(name, shape, dtype)

    def reads_pending(self) -> int:
        return 0

    def fence_reads(self) -> None:
        pass

    def next_read_slot(self) -> None:
        pass
