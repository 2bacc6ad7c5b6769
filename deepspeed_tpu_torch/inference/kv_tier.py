"""Tiered KV cache: the host pool for demoted prefix-cache pages (port of
``deepspeed_tpu/inference/kv_tier.py``; ref: ZeRO-Infinity tiering,
arXiv:2104.07857, and ZeRO-Offload host staging, arXiv:2101.06840).

The paged prefix cache keeps published refcount-0 pages warm on the device
until allocation pressure reclaims them; without a tier, reclaim means DROP
and the next prompt matching that span pays a full re-prefill.
:class:`KVTierPool` gives the allocator somewhere cheaper to put cold
pages:

    device warm pool ──demote──▶ host pool ──▶ drop
            ▲                        │
            └──────── promote ◀──────┘

- **Demote** (eviction pressure or the ``demote_watermark`` sweep): the
  page's KV — one ``[L, KV, ps, Dh]`` array pair across the layer stack —
  is copied device -> host and indexed under its content key.
  ``quantize_cold`` stores int8 codes + per-token-row f32 scales (~2x the
  pages per byte); off by default, keeping the tier bit-exact.
- **Overflow**: past ``host_pool_bytes`` the OLDEST unpinned entries drop.
  The NVMe rung below the host pool (``nvme_dir``) comes with the io slice
  and raises ``NotImplementedError`` until then.
- **Promote**: an admission matching a demoted span allocates fresh device
  pages and streams the payload back through
  :class:`~deepspeed_tpu_torch.param_stream.TierPageReader`; the pool
  implements its read interface (``get_submit`` / ``reads_pending`` /
  ``fence_reads`` / ``next_read_slot``) with host entries as zero-copy
  arrays.

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
import logging
import zlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.faults import ChecksumError
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


class KVTierPool:
    """Host pool for demoted KV pages, content-addressed by the same
    chained page keys as the device prefix cache.

    One pool per engine; the engine installs it as ``PageAllocator.spill``
    so the allocator's chain walk (``lookup_tiered``) treats demoted spans
    as cache hits, and as ``demote_hook`` so eviction captures the page
    instead of dropping it.  The pool is also the read backend of
    :class:`~deepspeed_tpu_torch.param_stream.TierPageReader`.

    Entries pinned via :meth:`pin` (an in-flight promotion's keys) are
    exempt from the overflow drop: a concurrent demotion must not delete
    an entry a promotion is about to read.  ``page_dtype`` is the cache's
    torch dtype."""

    def __init__(self, cfg, page_shape: Sequence[int], page_dtype):
        if cfg.nvme_dir:
            raise NotImplementedError(
                "kv_tier.nvme_dir (the NVMe spill rung) needs the aio "
                "module and the host C++ loader; it comes with the io slice")
        self.cfg = cfg
        self.page_shape = tuple(int(s) for s in page_shape)  # (L,KV,ps,Dh)
        self.page_dtype = page_dtype
        self.entries: Dict[bytes, TierEntry] = {}
        self._tick = 0
        self.host_bytes = 0
        self._pinned: Dict[bytes, int] = {}   # key -> pin count
        # age order, oldest first (touch() refreshes): the overflow pops
        # victims in O(pinned-skips), not O(entries)
        self._order: "collections.OrderedDict[bytes, None]" = \
            collections.OrderedDict()
        # circuit breaker: after repeated promote failures the engine
        # calls disable() — lookups miss and demotes become evictions,
        # while entries an in-flight promotion still reads stay intact
        self.disabled: Optional[str] = None
        self.dropped_pages = 0

    # ------------------------------------------------------- accounting
    def occupancy(self) -> Dict[str, object]:
        return {"host_pages": len(self.entries),
                "host_bytes": int(self.host_bytes),
                "dropped_pages": int(self.dropped_pages),
                "disabled": self.disabled}

    def disable(self, reason: str) -> None:
        """Circuit-break the tier: lookups miss (``has`` -> False) and
        demotes become plain evictions.  Idempotent."""
        if self.disabled is None:
            self.disabled = str(reason)
            logger.warning("kv_tier: tier DISABLED (%s): demotes become "
                           "evictions, tier hits become misses", reason)

    # ------------------------------------------------------------ index
    def has(self, key: bytes) -> bool:
        return self.disabled is None and key in self.entries

    def touch(self, key: bytes) -> Optional[str]:
        """Refresh an entry's age (re-demoting a span whose payload is
        still held is free: no copy)."""
        e = self.entries.get(key)
        if e is None:
            return None
        self._tick += 1
        e.tick = self._tick
        self._order.move_to_end(key)
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
        return self._land(encode_entry(
            key, k, v, quantize=self.cfg.quantize_cold,
            page_dtype=self.page_dtype, tick=self._tick))

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
        return self._land(encode_prequantized_entry(
            key, kq, ks, vq, vs, page_dtype=self.page_dtype,
            tick=self._tick))

    def _land(self, entry: TierEntry) -> Optional[str]:
        """Place a freshly encoded entry in the host pool, dropping the
        oldest unpinned entries to make room."""
        if entry.nbytes > self.cfg.host_pool_bytes:
            self.dropped_pages += 1
            return None
        while self.host_bytes + entry.nbytes > self.cfg.host_pool_bytes:
            victim = self._oldest()
            if victim is None:          # only pinned entries left
                self.dropped_pages += 1
                return None
            self._discard(victim, count_drop=True)
        self.entries[entry.key] = entry
        self.host_bytes += entry.nbytes
        self._order[entry.key] = None
        return "host"

    def _oldest(self) -> Optional[TierEntry]:
        for key in self._order:
            if key not in self._pinned:
                return self.entries[key]
        return None

    def _discard(self, e: TierEntry, count_drop: bool = False) -> None:
        self.entries.pop(e.key, None)
        self._order.pop(e.key, None)
        self.host_bytes -= e.nbytes
        if count_drop:
            self.dropped_pages += 1

    def discard(self, key: bytes) -> None:
        e = self.entries.get(key)
        if e is not None:
            self._discard(e)

    def host_view(self) -> "_HostOnlyView":
        """A channel-free read view for promotions whose keys are all
        host-resident (pinned, so they cannot leave mid-flight): no-op
        fencing, so any number of them run concurrently."""
        return _HostOnlyView(self)

    # ------------------------------------------ read interface (promote)
    def entry_meta(self, key: bytes):
        """(names, shapes, dtypes) of ``key``'s buffers — the read plan a
        TierPageReader submits."""
        e = self.entries[key]
        return (list(e.names), [b[1] for b in e.buffers],
                [b[2] for b in e.buffers])

    def _host_buffer(self, name: str) -> np.ndarray:
        hexk, i = name[len("kv_"):].rsplit("_", 1)
        e = self.entries[bytes.fromhex(hexk)]
        if e.location != "host":
            raise RuntimeError(f"promotion read of {name} found the entry "
                               f"on {e.location!r}")
        return e.data[int(i)]

    def get_submit(self, name: str, shape, dtype, out=None):
        # zero-copy: the stored array IS the fenced buffer
        return self._host_buffer(name)

    def read_sync(self, name: str, shape, dtype) -> np.ndarray:
        return self._host_buffer(name)

    def reads_pending(self) -> int:
        return 0

    def fence_reads(self) -> None:
        pass

    def next_read_slot(self) -> None:
        pass

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
        return self._pool._host_buffer(name)

    def reads_pending(self) -> int:
        return 0

    def fence_reads(self) -> None:
        pass

    def next_read_slot(self) -> None:
        pass
