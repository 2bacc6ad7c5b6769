"""Cross-replica KV fabric: a shared, content-addressed exchange of
serialized KV pages (port of ``deepspeed_tpu/kv_fabric.py``; host-only).

Inside one engine the KV tier demotes pages, spills them and promotes
them back through a checksum-verified path with a re-prefill fallback.
This module lifts the exact same payloads one level up: fleet replicas
PUBLISH page chains into the fabric and FETCH chains another replica
computed, so

- an **affinity miss** where another replica's digest covers the
  prompt becomes a migration (the router asks the owner to export the
  matching chain, the target admits it into its own spill pool and
  re-admits through the existing tier-promotion path) instead of a full
  re-prefill, and
- a **disaggregated fleet** (``fleet.roles``) hands prompts from
  prefill-specialized replicas to decode-specialized ones as migrated
  admissions.

The entries are the spill tier's own :class:`~deepspeed_tpu_torch.
inference.prefix_cache.TierEntry` records: serialized buffers with the
per-buffer crc32 recorded at encode time, int8-quantized cold pages
riding as-is.  Nothing downstream trusts the transport — the ADMITTING
replica's promotion decodes against the original checksums, so
corruption anywhere between export and scatter falls back to re-prefill
exactly like a failed tier promotion.

Chaos surface: the ``faults`` plan's ``fabric`` rules fire at
:meth:`KVFabric.publish` (key ``export:<hex>``; error = failed export),
:meth:`KVFabric.fetch` (key ``fetch:<hex>``; latency pushes a migration
toward its timeout, error fails it) and after the publish checksum
passthrough (key ``corrupt:<hex>``; error flips a payload byte in the
fabric's copy — never the owner's — so only importers see it).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from deepspeed_tpu_torch import faults as _faults
from deepspeed_tpu_torch.config import FabricConfig
from deepspeed_tpu_torch.inference.prefix_cache import TierEntry, key_hex
from deepspeed_tpu_torch.utils.logging import logger


class FabricExportError(IOError):
    """An export into the fabric failed (injected or real): the
    migration falls back to re-prefill — correctness preserved, the
    DMA saving lost."""


class KVFabric:
    """Content-addressed KV-page exchange shared by fleet replicas.

    One fabric per fleet (built by :func:`~deepspeed_tpu_torch.fleet.
    fleet_router`, or directly for tests); replicas reach it through
    :meth:`~deepspeed_tpu_torch.inference.serving.ServingEngine.export_pages`
    / ``admit_fabric``.  Entries are host-resident serialized payloads
    capped at ``capacity_bytes`` with oldest-first eviction — the
    fabric is a TRANSIT BUFFER, not a third storage tier: an evicted
    chain just means the next migration re-exports from its owner (or
    the target re-prefills).

    Single-router threading model: the fleet's submit/step loop is the
    only caller, so no internal locking — same contract as the router
    itself.
    """

    def __init__(self, fabric=None, registry=None):
        self.cfg = FabricConfig.coerce(fabric)
        self.entries: "collections.OrderedDict[bytes, TierEntry]" = \
            collections.OrderedDict()
        self.bytes = 0
        # host-side lifetime accounting (works with telemetry disabled;
        # a chaos run reconciles these against the registry family)
        self.exports = 0            # pages published (dedups excluded)
        self.fetches = 0            # pages fetched
        self.bytes_in = 0           # serialized bytes exported in
        self.bytes_out = 0          # serialized bytes fetched out
        self.export_failures = 0
        self.fetch_failures = 0
        self.evicted = 0
        self.corrupted = 0          # injected in-fabric corruptions
        if registry is None or not getattr(registry, "enabled", False):
            from deepspeed_tpu_torch.telemetry import NULL_METRIC

            self._c_exports = self._c_fetches = NULL_METRIC
            self._c_bytes_in = self._c_bytes_out = NULL_METRIC
            self._c_exp_fail = self._c_fetch_fail = NULL_METRIC
            self._c_evicted = NULL_METRIC
            self._g_entries = self._g_bytes = NULL_METRIC
            self.h_migrate = NULL_METRIC
        else:
            r = registry
            self._c_exports = r.counter(
                "kv_fabric_exports",
                "pages published into the fabric (dedup hits excluded)")
            self._c_fetches = r.counter(
                "kv_fabric_fetches",
                "pages fetched out of the fabric for a migrated "
                "admission")
            self._c_bytes_in = r.counter(
                "kv_fabric_bytes_in",
                "serialized payload bytes exported into the fabric")
            self._c_bytes_out = r.counter(
                "kv_fabric_bytes_out",
                "serialized payload bytes fetched out of the fabric")
            self._c_exp_fail = r.counter(
                "kv_fabric_export_failures",
                "page exports that failed (the migration falls back "
                "to re-prefill for the uncovered span)")
            self._c_fetch_fail = r.counter(
                "kv_fabric_fetch_failures",
                "page fetches that failed (the admitting replica "
                "re-prefills the uncovered span)")
            self._c_evicted = r.counter(
                "kv_fabric_evicted_entries",
                "entries evicted oldest-first under capacity_bytes")
            self._g_entries = r.gauge(
                "kv_fabric_entries", "pages resident in the fabric")
            self._g_bytes = r.gauge(
                "kv_fabric_bytes", "serialized bytes resident")
            # observed by the router around one whole migration
            # (export leg + fetch/admit leg)
            self.h_migrate = r.histogram(
                "kv_fabric_migrate_seconds",
                "one cross-replica migration, export-start -> "
                "admitted (timeouts counted as fallbacks instead)")

    # ------------------------------------------------------------ index
    def has(self, key: bytes) -> bool:
        return key in self.entries

    def covers(self, keys: Sequence[bytes]) -> int:
        """Longest CONTIGUOUS prefix of ``keys`` resident in the
        fabric — chain semantics, same as the allocator's tier walk."""
        n = 0
        for k in keys:
            if k not in self.entries:
                break
            n += 1
        return n

    def _refresh_gauges(self) -> None:
        self._g_entries.set(len(self.entries))
        self._g_bytes.set(self.bytes)

    # ---------------------------------------------------------- publish
    def publish(self, key: bytes, entry: TierEntry) -> bool:
        """Export one serialized page into the fabric.  The payload
        arrays are COPIED — the fabric's lifetime (and its injected
        corruptions) must never alias the owner's live spill entries.
        Dedup: a key already resident just refreshes its age.  Raises
        :class:`FabricExportError` on an injected/real export failure
        (the caller counts it and the migration degrades)."""
        hexk = key_hex(key)
        delay, err = _faults.poll("fabric", f"export:{hexk}")
        if delay:
            time.sleep(delay)
        if err is not None:
            self.export_failures += 1
            self._c_exp_fail.inc()
            raise FabricExportError(
                f"injected fabric export failure ({hexk[:12]})")
        if key in self.entries:
            self.entries.move_to_end(key)
            return False
        data = tuple(np.array(b, copy=True) for b in entry.data)
        e = dataclasses.replace(entry, location="host", data=data)
        _delay, corrupt = _faults.poll("fabric", f"corrupt:{hexk}")
        if corrupt is not None:
            # AFTER the checksum passthrough: the importer's decode
            # must catch exactly this and re-prefill
            _faults.corrupt_array(e.data[0])
            self.corrupted += 1
        if e.nbytes > self.cfg.capacity_bytes:
            # BEFORE the eviction loop: an unpublishable oversized
            # entry must not flush every other replica's in-flight
            # chains first
            logger.warning(
                "kv_fabric: entry %s (%d B) exceeds capacity_bytes %d "
                "— not published", hexk[:12], e.nbytes,
                self.cfg.capacity_bytes)
            return False
        while self.bytes + e.nbytes > self.cfg.capacity_bytes \
                and self.entries:
            old_key, old = self.entries.popitem(last=False)
            self.bytes -= old.nbytes
            self.evicted += 1
            self._c_evicted.inc()
        self.entries[key] = e
        self.bytes += e.nbytes
        self.exports += 1
        self.bytes_in += e.nbytes
        self._c_exports.inc()
        self._c_bytes_in.inc(e.nbytes)
        self._refresh_gauges()
        return True

    # ------------------------------------------------------------ fetch
    def fetch(self, key: bytes) -> TierEntry:
        """One page out of the fabric for a migrated admission.
        Latency rules sleep here (pushing the migration toward its
        ``migrate_timeout_s`` — the router abandons the remainder);
        error rules raise (the caller counts a fetch failure and the
        uncovered span re-prefills).  KeyError when the entry evicted
        since ``covers()``."""
        hexk = key_hex(key)
        delay, err = _faults.poll("fabric", f"fetch:{hexk}")
        if delay:
            time.sleep(delay)
        if err is not None:
            self.fetch_failures += 1
            self._c_fetch_fail.inc()
            raise IOError(
                f"injected fabric fetch failure ({hexk[:12]})")
        e = self.entries[key]
        self.entries.move_to_end(key)
        self.fetches += 1
        self.bytes_out += e.nbytes
        self._c_fetches.inc()
        self._c_bytes_out.inc(e.nbytes)
        return e

    # ------------------------------------------------------ introspection
    def occupancy(self) -> Dict[str, Any]:
        return {
            "entries": len(self.entries),
            "bytes": int(self.bytes),
            "capacity_bytes": int(self.cfg.capacity_bytes),
            "exports": int(self.exports),
            "fetches": int(self.fetches),
            "bytes_moved": int(self.bytes_in + self.bytes_out),
            "export_failures": int(self.export_failures),
            "fetch_failures": int(self.fetch_failures),
            "evicted": int(self.evicted),
            "corrupted": int(self.corrupted),
        }
