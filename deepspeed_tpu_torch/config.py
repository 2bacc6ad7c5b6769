"""Config system accepting DeepSpeed-style JSON (ref: deepspeed/runtime/config.py).

Port copy of ``deepspeed_tpu/config.py``, kept whole so that one JSON parses
the same in both packages.  An enabled ``random_ltd`` block, whose
validation lives in a module not ported yet, raises
``NotImplementedError`` at parse time; an enabled ``faults`` block is
validated by the port's :class:`~deepspeed_tpu_torch.faults.FaultPlan`;
``curriculum_learning`` parses into the port's
:class:`~deepspeed_tpu_torch.data.curriculum.CurriculumConfig` and an
enabled ``elasticity`` block into the port's
:class:`~deepspeed_tpu_torch.elasticity.ElasticityConfig`.

The reference parses a JSON dict (``train_batch_size``,
``zero_optimization``, ``fp16``/``bf16``, ``optimizer``, ``scheduler``,
``gradient_clipping`` …) into a ``DeepSpeedConfig`` object with validation
of the batch-size arithmetic.  We keep the same keys and arithmetic so an
existing config file works unchanged, and add a ``mesh`` block describing
the TPU device-mesh topology (there is no NCCL analogue — parallelism
degrees ARE the config here).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, Optional


def temp_path(name: str) -> str:
    """``name`` under the process's temp directory (``TMPDIR`` when set):
    where the default swap, flight-recorder and incident directories go."""
    return os.path.join(tempfile.gettempdir(), name)


# Defaults mirror the reference's constants
# (ref: deepspeed/runtime/constants.py, deepspeed/runtime/zero/config.py).
TRAIN_BATCH_SIZE = "train_batch_size"
MICRO_BATCH = "train_micro_batch_size_per_gpu"
GRAD_ACCUM = "gradient_accumulation_steps"


@dataclasses.dataclass
class ZeroConfig:
    """ref: deepspeed/runtime/zero/config.py (DeepSpeedZeroConfig)."""

    stage: int = 0
    # On TPU the partition granularity is the GSPMD sharding; these knobs
    # are accepted for compatibility and used as hints.
    reduce_scatter: bool = True
    overlap_comm: bool = True
    contiguous_gradients: bool = True
    offload_param: Optional[Dict[str, Any]] = None      # {"device": "cpu"|"nvme", ...}
    offload_optimizer: Optional[Dict[str, Any]] = None
    zeropp_quantized_gradients: bool = False            # ZeRO++ qgZ
    zeropp_quantized_weights: bool = False
    sub_group_size: int = 0

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ZeroConfig":
        d = dict(d)
        # reference ZeRO++ key spellings (deepspeed/runtime/zero/config.py)
        for ref_key, ours in (("zero_quantized_gradients", "zeropp_quantized_gradients"),
                              ("zero_quantized_weights", "zeropp_quantized_weights")):
            if ref_key in d:
                d.setdefault(ours, d.pop(ref_key))
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        z = cls(**kwargs)
        if not 0 <= z.stage <= 3:
            raise ValueError(f"zero_optimization.stage must be 0..3, got {z.stage}")
        return z


@dataclasses.dataclass
class ZeroInferenceConfig:
    """ZeRO-Inference serving block (ref: deepspeed ZeRO-Inference,
    arXiv:2206.01861, built on ZeRO-Infinity's parameter offload,
    arXiv:2104.07857): serve models whose weight image exceeds HBM by
    hosting transformer-layer weights on a host-RAM or NVMe tier and
    streaming them through a small double-buffered HBM working set while
    stem + head stay resident.

    ``hbm_budget_bytes``: the planner pins as many layers HBM-resident
    as fit under this budget (stem + head + KV cache + the prefetch
    working set are charged first) and streams the rest; ``None``
    streams every layer — the serve-anything default, matching the
    reference's "no pinning" posture.  ``dtype``: streamed-weight dtype
    override (``None`` inherits the builder's ``weight_dtype``; int8
    composes — the tier then holds int8 codes + group scales and the
    per-layer dequant is traced into each block program).
    """

    enabled: bool = False
    hbm_budget_bytes: Optional[int] = None
    prefetch_depth: int = 1
    tier: str = "host"                   # host | nvme
    nvme_path: str = temp_path("dstpu_nvme_swap")
    dtype: Optional[str] = None          # None (inherit) | bfloat16 | int8
    # bounded retry for transient tier-read failures: a failed stream
    # fence resubmits up to io_retries times (exponential backoff from
    # io_retry_backoff_s), then falls over to a synchronous read of the
    # tier file before raising a structured fatal with a postmortem
    io_retries: int = 2
    io_retry_backoff_s: float = 0.05

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ZeroInferenceConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        z = cls(**{k: v for k, v in d.items() if k in known})
        z.io_retries = int(z.io_retries)
        z.io_retry_backoff_s = float(z.io_retry_backoff_s)
        if z.io_retries < 0:
            raise ValueError(
                f"zero_inference.io_retries must be >= 0, got "
                f"{z.io_retries}")
        if z.io_retry_backoff_s < 0:
            raise ValueError(
                f"zero_inference.io_retry_backoff_s must be >= 0, got "
                f"{z.io_retry_backoff_s}")
        if z.tier not in ("host", "nvme"):
            raise ValueError(
                f"zero_inference.tier must be 'host' or 'nvme', got "
                f"{z.tier!r}")
        if z.hbm_budget_bytes is not None and z.hbm_budget_bytes <= 0:
            raise ValueError(
                f"zero_inference.hbm_budget_bytes must be positive or "
                f"null (null = stream every layer), got "
                f"{z.hbm_budget_bytes}")
        if z.prefetch_depth < 1:
            raise ValueError(
                f"zero_inference.prefetch_depth must be >= 1, got "
                f"{z.prefetch_depth}")
        if z.dtype not in (None, "bfloat16", "int8"):
            raise ValueError(
                f"zero_inference.dtype must be bfloat16 or int8, got "
                f"{z.dtype!r}")
        return z

    @classmethod
    def coerce(cls, obj) -> "ZeroInferenceConfig":
        """Accept a dict, a ZeroInferenceConfig, or None (disabled)."""
        if obj is None:
            return cls(enabled=False)
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, dict):
            d = dict(obj)
            d.setdefault("enabled", True)   # passing a block opts in
            return cls.from_dict(d)
        raise TypeError(
            f"zero_inference must be a dict or ZeroInferenceConfig, got "
            f"{type(obj).__name__}")


@dataclasses.dataclass
class PrefixCacheConfig:
    """Automatic prefix caching for the paged-KV serving path (ref:
    vLLM automatic prefix caching / SGLang RadixAttention; the same
    memory-wall framing as ZeRO-Infinity, arXiv:2104.07857, applied to
    HBM KV pages — a scarce tier managed as a deduplicated cache, not
    per-request scratch).

    Full KV pages are content-addressed by a chained hash of their
    token span; an incoming prompt maps to its longest cached
    page-aligned prefix, matched pages are shared into the new
    sequence's page table with refcount bumps, and prefill starts at
    the first uncached token.  Pages released by finished or preempted
    sequences enter a warm pool (eviction-ordered) that is only
    reclaimed when allocation pressure demands it, so completed
    requests keep warming the cache.

    ``max_cached_pages`` caps the refcount-0 warm pool in pages;
    ``max_hbm_fraction`` caps it as a fraction of the usable page pool
    (both set → the smaller wins).  ``eviction``: ``lru`` (reuse
    refreshes recency) or ``fifo`` (publish order).
    """

    enabled: bool = False
    max_cached_pages: Optional[int] = None   # None = bound by fraction
    max_hbm_fraction: float = 1.0            # of the usable page pool
    eviction: str = "lru"                    # lru | fifo

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PrefixCacheConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        p = cls(**{k: v for k, v in d.items() if k in known})
        if p.eviction not in ("lru", "fifo"):
            raise ValueError(
                f"prefix_cache.eviction must be 'lru' or 'fifo', got "
                f"{p.eviction!r}")
        if p.max_cached_pages is not None and p.max_cached_pages < 0:
            raise ValueError(
                f"prefix_cache.max_cached_pages must be >= 0, got "
                f"{p.max_cached_pages}")
        if not 0.0 <= p.max_hbm_fraction <= 1.0:
            raise ValueError(
                f"prefix_cache.max_hbm_fraction must be in [0, 1], got "
                f"{p.max_hbm_fraction}")
        return p

    @classmethod
    def coerce(cls, obj) -> "PrefixCacheConfig":
        """Accept None (disabled), a bool, a dict (writing the block is
        the opt-in, like ``zero_inference``), or a PrefixCacheConfig."""
        if obj is None:
            return cls(enabled=False)
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, bool):
            return cls(enabled=obj)
        if isinstance(obj, dict):
            d = dict(obj)
            d.setdefault("enabled", True)   # passing a block opts in
            return cls.from_dict(d)
        raise TypeError(
            f"prefix_cache must be a bool, dict or PrefixCacheConfig, "
            f"got {type(obj).__name__}")

    def pool_cap(self, usable_pages: int) -> int:
        """Resolve the warm-pool cap against a concrete page pool."""
        if not self.enabled:
            return 0
        cap = int(self.max_hbm_fraction * usable_pages)
        if self.max_cached_pages is not None:
            cap = min(cap, self.max_cached_pages)
        return max(cap, 0)


@dataclasses.dataclass
class KVTierConfig:
    """Tiered KV cache for the paged prefix pool (ref: ZeRO-Infinity's
    memory tiering, arXiv:2104.07857, and ZeRO-Offload's host staging,
    arXiv:2101.06840 — applied to KV pages the way ZeRO-Inference
    applies it to layer weights).

    With the block on, a published refcount-0 prefix-cache page that
    would be reclaimed under allocation pressure (or proactively, once
    the warm pool fills past ``demote_watermark``) is DEMOTED to a host
    pool — and from there, when the host pool overflows and
    ``nvme_dir`` is set, spilled to NVMe via the aio pool — instead of
    being dropped from the content index.  A later prompt matching the
    demoted span re-admits it through a double-buffered promotion
    pipeline (``param_stream.TierPageReader``) overlapped with the
    uncached-suffix prefill chunks, so an evicted system prompt costs a
    DMA instead of a re-prefill.

    ``quantize_cold``: int8-quantize pages on demote (per-token-row
    scales; dequantized on promote) so the cold tiers hold ~2x the
    pages.  Off by default — the spill path is then bit-exact and
    served tokens are identical to tiering off.
    ``quantized_resident`` (requires ``quantize_cold``): keep promoted
    pages int8 IN HBM — the promotion publishes the stored codes +
    per-token-row scales directly (no dequant, no f32 scatter) and the
    attention kernel dequantizes in VMEM per block
    (``paged_chunk_attention_v2_quant``), so the resident KV pool holds
    ~2x the pages per HBM byte; accuracy stays within the same
    documented ``KV_TIER_QUANT_RTOL`` bound as ``quantize_cold``
    because the codes round-trip losslessly once quantized.
    ``demote_watermark``
    is a fraction of the warm-pool cap: occupancy above it demotes the
    oldest warm pages proactively (1.0 = demote only under allocation
    pressure).  ``promote_group_pages`` is the double-buffer granule of
    the promotion pipeline.
    """

    enabled: bool = False
    host_pool_bytes: int = 256 << 20
    nvme_dir: Optional[str] = None
    nvme_pool_bytes: Optional[int] = None    # None = unbounded
    quantize_cold: bool = False
    quantized_resident: bool = False
    demote_watermark: float = 1.0
    promote_group_pages: int = 8
    aio_threads: int = 4
    # robustness knobs: bounded promote-read retry (resubmit + backoff,
    # then a synchronous file read, before the engine falls back to
    # re-prefill), and a circuit breaker — disable_after consecutive
    # failed promotions disable the tier (demotes become plain
    # evictions, tier lookups miss; 0 = never disable)
    io_retries: int = 2
    io_retry_backoff_s: float = 0.05
    disable_after: int = 4

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "KVTierConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        k = cls(**{kk: v for kk, v in d.items() if kk in known})
        k.host_pool_bytes = int(k.host_pool_bytes)
        k.promote_group_pages = int(k.promote_group_pages)
        k.aio_threads = int(k.aio_threads)
        k.demote_watermark = float(k.demote_watermark)
        k.io_retries = int(k.io_retries)
        k.io_retry_backoff_s = float(k.io_retry_backoff_s)
        k.disable_after = int(k.disable_after)
        if k.io_retries < 0:
            raise ValueError(
                f"kv_tier.io_retries must be >= 0, got {k.io_retries}")
        if k.io_retry_backoff_s < 0:
            raise ValueError(
                f"kv_tier.io_retry_backoff_s must be >= 0, got "
                f"{k.io_retry_backoff_s}")
        if k.disable_after < 0:
            raise ValueError(
                f"kv_tier.disable_after must be >= 0 (0 = never), got "
                f"{k.disable_after}")
        if k.host_pool_bytes < 0:
            raise ValueError(
                f"kv_tier.host_pool_bytes must be >= 0, got "
                f"{k.host_pool_bytes}")
        if k.nvme_pool_bytes is not None:
            # store the coerced value, like every sibling field — a
            # string from env/YAML must not survive to compare against
            # byte counts at the first spill
            k.nvme_pool_bytes = int(k.nvme_pool_bytes)
            if k.nvme_pool_bytes <= 0:
                raise ValueError(
                    f"kv_tier.nvme_pool_bytes must be positive or null "
                    f"(null = unbounded), got {k.nvme_pool_bytes}")
        if not 0.0 <= k.demote_watermark <= 1.0:
            raise ValueError(
                f"kv_tier.demote_watermark must be in [0, 1], got "
                f"{k.demote_watermark}")
        if k.promote_group_pages < 1:
            raise ValueError(
                f"kv_tier.promote_group_pages must be >= 1, got "
                f"{k.promote_group_pages}")
        if k.aio_threads < 1:
            raise ValueError(
                f"kv_tier.aio_threads must be >= 1, got {k.aio_threads}")
        k.quantized_resident = bool(k.quantized_resident)
        k.quantize_cold = bool(k.quantize_cold)
        if k.quantized_resident and not k.quantize_cold:
            # the resident pool holds the SAME int8 codes the cold tier
            # stores — without quantize_cold there is nothing to publish
            raise ValueError(
                "kv_tier.quantized_resident requires "
                "kv_tier.quantize_cold: true (it serves the cold tier's "
                "int8 pages in place)")
        return k

    @classmethod
    def coerce(cls, obj) -> "KVTierConfig":
        """Accept None (disabled), a bool, a dict (writing the block is
        the opt-in, like ``prefix_cache``), or a KVTierConfig."""
        if obj is None:
            return cls(enabled=False)
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, bool):
            return cls(enabled=obj)
        if isinstance(obj, dict):
            d = dict(obj)
            d.setdefault("enabled", True)   # passing a block opts in
            return cls.from_dict(d)
        raise TypeError(
            f"kv_tier must be a bool, dict or KVTierConfig, got "
            f"{type(obj).__name__}")


@dataclasses.dataclass
class CommConfig:
    """Collective-communication policy: hierarchical two-level
    collectives + the int8 wire codec shared by ZeRO-3 training and TP
    serving (ZeRO++ arXiv:2306.10209, EQuARX arXiv:2506.17615).

    ``hierarchy_size`` factors the ``data`` axis into ``(inter,
    intra)`` sub-groups of ``intra = hierarchy_size`` devices each: the
    compressed gradient all-reduce runs intra-reduce → quantized
    inter-exchange → intra-gather, and the qwZ weight all-gather
    resolves intra-node against an hpZ secondary shard (the full-axis
    int8 hop becomes an ``inter``-sized one).  ``0`` auto-detects from
    the device topology (devices-per-process on a multi-host mesh;
    flat on a single host), ``1`` forces the flat single-level paths,
    ``k > 1`` must divide the data-parallel world (resolution raises
    otherwise — a silently-flat "hierarchical" config is a perf bug).

    ``codec`` picks the wire encoding for the compressed collectives:
    ``blockwise`` (the v2 per-block int8 codec, scales over 8x512
    TPU-tile blocks), ``group`` (the legacy flat 512-element group
    scheme, kept for A/B), or ``exact`` (f32 on the wire — the
    bit-exact bypass kept for verification; hierarchical routing still
    applies).  ``bits`` is the integer wire width for the non-exact
    codecs.

    ``bucket_mb`` splits the raveled gradient tree into fixed-size
    buckets reduced under a ``lax.scan`` so XLA can overlap bucket
    ``k``'s collective with bucket ``k+1``'s work (the reference's
    NCCL-bucket idiom); ``0`` keeps the single monolithic buffer.
    Bucket boundaries are aligned to the codec block grid, so bucketed
    and monolithic paths ship identical int8 codes and scales (grads
    agree to f32 rounding).

    ``quantized_serving`` opts TP replica weight placement and the
    ZeRO-Inference layer upload into the same int8 wire (blockwise
    codes + scales travel host→HBM, dequantized on device).  Default
    off: greedy token identity is preserved via the bit-exact path;
    the int8 arm is gated by ``serving_rtol`` (max relative weight
    error the placement may introduce — exceeding it raises).
    """

    hierarchy_size: int = 0
    bucket_mb: float = 0.0
    bits: int = 8
    codec: str = "blockwise"
    quantized_serving: bool = False
    serving_rtol: float = 0.05

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CommConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown comm config keys: {sorted(unknown)} "
                f"(known: {sorted(known)})")
        c = cls(**{k: v for k, v in d.items() if k in known})
        c.hierarchy_size = int(c.hierarchy_size)
        c.bucket_mb = float(c.bucket_mb)
        c.bits = int(c.bits)
        c.codec = str(c.codec)
        c.quantized_serving = bool(c.quantized_serving)
        c.serving_rtol = float(c.serving_rtol)
        if c.hierarchy_size < 0:
            raise ValueError(
                f"comm.hierarchy_size must be >= 0 (0 = auto-detect), "
                f"got {c.hierarchy_size}")
        if c.bucket_mb < 0:
            raise ValueError(
                f"comm.bucket_mb must be >= 0 (0 = monolithic), "
                f"got {c.bucket_mb}")
        if c.codec not in ("blockwise", "group", "exact"):
            raise ValueError(
                f"comm.codec must be one of blockwise|group|exact, "
                f"got {c.codec!r}")
        if c.bits not in (4, 8):
            raise ValueError(
                f"comm.bits must be 4 or 8, got {c.bits}")
        if not 0 < c.serving_rtol <= 1:
            raise ValueError(
                f"comm.serving_rtol must be in (0, 1], "
                f"got {c.serving_rtol}")
        return c

    @classmethod
    def coerce(cls, obj) -> "CommConfig":
        """Accept None (all-default policy), a dict, or a CommConfig —
        like ``kernels`` there is no enabled switch: the defaults ARE
        the policy (auto hierarchy, blockwise codec, monolithic
        buckets, bit-exact serving)."""
        if obj is None:
            return cls()
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, dict):
            return cls.from_dict(dict(obj))
        raise TypeError(
            f"comm must be a dict or CommConfig, got "
            f"{type(obj).__name__}")


@dataclasses.dataclass
class KernelsConfig:
    """Serving kernel-dispatch policy (the config-first replacement for
    the ``DSTPU_FORCE_PAGED_PALLAS`` / ``DSTPU_PAGED_V1`` env-flag
    folklore).

    ``paged_attention`` picks the paged decode/chunk attention
    implementation: ``auto`` (the shape-measured crossover gate,
    ``pallas_paged_gate`` — XLA gather below the crossover, the Pallas
    v2 DMA kernel above it), ``xla`` (always the gather reference
    composition), ``pallas_v1`` (the one-page-per-grid-step kernel,
    kept for A/B), or ``pallas_v2`` (force the double-buffered DMA
    kernel).  ``fused_sampling`` picks the boundary/decode sampler:
    ``auto`` (crossover gate on batch x vocab), ``off`` (the jitted XLA
    ``_sample_rows``), ``on`` (force the fused Pallas greedy kernel;
    greedy output is bit-exact either way).

    Resolution happens ONCE at engine build (``resolve_serving_kernels``
    in :mod:`deepspeed_tpu_torch.inference.kernels`): env vars still win as
    overrides at that point, the resolved policy is baked into the
    compiled programs and surfaced in ``/statusz`` under ``kernels``,
    and a forced Pallas choice that the build must demote (tensor
    parallelism — the kernel is per-device) falls back VISIBLY with a
    recorded reason + counter instead of silently.
    """

    paged_attention: str = "auto"
    fused_sampling: str = "auto"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "KernelsConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        k = cls(**{kk: v for kk, v in d.items() if kk in known})
        k.paged_attention = str(k.paged_attention)
        k.fused_sampling = str(k.fused_sampling)
        if k.paged_attention not in ("auto", "xla", "pallas_v1",
                                     "pallas_v2"):
            raise ValueError(
                f"kernels.paged_attention must be one of auto|xla|"
                f"pallas_v1|pallas_v2, got {k.paged_attention!r}")
        if k.fused_sampling not in ("auto", "off", "on"):
            raise ValueError(
                f"kernels.fused_sampling must be one of auto|off|on, "
                f"got {k.fused_sampling!r}")
        return k

    @classmethod
    def coerce(cls, obj) -> "KernelsConfig":
        """Accept None (all-auto defaults), a dict, or a KernelsConfig —
        there is no enabled switch: ``auto`` IS the default policy."""
        if obj is None:
            return cls()
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, dict):
            return cls.from_dict(dict(obj))
        raise TypeError(
            f"kernels must be a dict or KernelsConfig, got "
            f"{type(obj).__name__}")


@dataclasses.dataclass
class SpeculativeConfig:
    """Speculative decoding block for the paged-KV serving path (ref:
    speculative sampling, arXiv:2302.01318 / prompt-lookup decoding;
    the ZeRO-Inference framing of arXiv:2206.01861 is what makes it
    decisive here — a weight-streamed decode pays one full layer-weight
    stream PER SWEEP, so scoring K+1 positions in one sweep divides the
    streamed bytes per generated token by the mean acceptance length).

    Each decode iteration drafts up to ``draft_tokens`` cheap tokens
    per active slot, scores all K+1 positions in ONE batched
    continuation forward (the verify pass), keeps the longest accepted
    prefix plus one bonus/corrected token, and rewinds the KV frontier
    past the rejected tail.  Outputs are unchanged: greedy acceptance
    is exact equality against the target argmax, temperature>0 uses
    point-mass rejection sampling (drafters propose deterministically,
    so accepting ``d`` with probability ``p(d)`` and otherwise sampling
    from ``p`` with ``d``'s mass removed reproduces the target
    distribution exactly).

    ``drafter``: ``ngram`` (zero-weight prompt-lookup over the
    request's own prompt + generated history) or ``model`` (a resident
    small draft model — build it explicitly and pass ``drafter=`` to
    the engine, the config block cannot carry params).  ``max_ngram``/
    ``min_ngram`` bound the suffix match the ngram drafter searches.
    """

    enabled: bool = False
    drafter: str = "ngram"               # ngram | model
    draft_tokens: int = 4                # K: drafts per verify sweep
    max_ngram: int = 3                   # longest suffix match tried
    min_ngram: int = 1                   # shortest suffix match tried

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SpeculativeConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        s = cls(**{k: v for k, v in d.items() if k in known})
        s.draft_tokens = int(s.draft_tokens)
        s.max_ngram = int(s.max_ngram)
        s.min_ngram = int(s.min_ngram)
        if s.drafter not in ("ngram", "model"):
            raise ValueError(
                f"speculative.drafter must be 'ngram' or 'model', got "
                f"{s.drafter!r}")
        if s.draft_tokens < 1:
            raise ValueError(
                f"speculative.draft_tokens must be >= 1, got "
                f"{s.draft_tokens}")
        if not 1 <= s.min_ngram <= s.max_ngram:
            raise ValueError(
                f"speculative needs 1 <= min_ngram <= max_ngram, got "
                f"min_ngram={s.min_ngram} max_ngram={s.max_ngram}")
        return s

    @classmethod
    def coerce(cls, obj) -> "SpeculativeConfig":
        """Accept None (disabled), a bool, a dict (writing the block is
        the opt-in, like ``zero_inference``), or a SpeculativeConfig."""
        if obj is None:
            return cls(enabled=False)
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, bool):
            return cls(enabled=obj)
        if isinstance(obj, dict):
            d = dict(obj)
            d.setdefault("enabled", True)   # passing a block opts in
            return cls.from_dict(d)
        raise TypeError(
            f"speculative must be a bool, dict or SpeculativeConfig, "
            f"got {type(obj).__name__}")


@dataclasses.dataclass
class SLOTierObjective:
    """One tier's latency objectives (all optional — an unset objective
    never violates).  ``ttft_s``: submit → first token; ``itl_s``: the
    WORST inter-token gap a client of this request observed (chunked
    decode delivers bursts, so the sync-interval gap is what this
    bounds); ``deadline_s``: submit → finish.  ``target`` is the
    attainment objective (the fraction of requests that must meet every
    set objective — the SLO proper); the burn rate divides the observed
    violation rate by the error budget ``1 - target``."""

    ttft_s: Optional[float] = None
    itl_s: Optional[float] = None
    deadline_s: Optional[float] = None
    target: float = 0.99

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SLOTierObjective":
        known = {f.name for f in dataclasses.fields(cls)}
        t = cls(**{k: v for k, v in d.items() if k in known})
        for name in ("ttft_s", "itl_s", "deadline_s"):
            v = getattr(t, name)
            if v is not None:
                v = float(v)
                setattr(t, name, v)
                if v <= 0:
                    raise ValueError(
                        f"slo tier objective {name} must be positive or "
                        f"null, got {v}")
        t.target = float(t.target)
        if not 0.0 < t.target <= 1.0:
            raise ValueError(
                f"slo tier target must be in (0, 1], got {t.target}")
        return t


@dataclasses.dataclass
class SLOConfig:
    """Per-tier serving SLO block (the control-plane contract the
    multi-replica router routes on; same stall-attribution motivation
    as the ZeRO-Infinity tiering papers, arXiv:2104.07857 /
    arXiv:2101.06840 — a stream stall that silently eats a TTFT budget
    must surface as a violated objective, not folklore).

    ``tiers`` maps tier name → :class:`SLOTierObjective`; ``submit``
    callers pick a tier per request (unset → ``default_tier``).  Every
    request is classified attained/violated at finish; the tracker
    keeps a ``window_s`` rolling attainment + goodput (tokens/s counted
    ONLY for attained requests) and one burn-rate gauge per entry of
    ``burn_windows_s``.  When the burn rate exceeds
    ``burn_threshold`` in EVERY window simultaneously (the standard
    multiwindow alert — fast windows catch the spike, slow windows
    suppress flapping), the alert hook fires a structured
    ``slo_burn_alert`` event into the flight recorder."""

    enabled: bool = False
    tiers: Dict[str, SLOTierObjective] = dataclasses.field(
        default_factory=dict)
    default_tier: str = "default"
    window_s: float = 60.0
    burn_windows_s: tuple = (60.0, 300.0)
    burn_threshold: float = 2.0

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SLOConfig":
        d = dict(d)
        tiers = {name: (t if isinstance(t, SLOTierObjective)
                        else SLOTierObjective.from_dict(t))
                 for name, t in d.pop("tiers", {}).items()}
        known = {f.name for f in dataclasses.fields(cls)}
        s = cls(**{k: v for k, v in d.items() if k in known and
                   k != "tiers"}, tiers=tiers)
        if not s.tiers:
            # a bare {"enabled": true} block still tracks: one default
            # tier with no objectives (everything attains — the
            # goodput == throughput baseline)
            s.tiers = {s.default_tier: SLOTierObjective()}
        if s.default_tier not in s.tiers:
            raise ValueError(
                f"slo.default_tier {s.default_tier!r} not in tiers "
                f"{sorted(s.tiers)}")
        s.window_s = float(s.window_s)
        if s.window_s <= 0:
            raise ValueError(
                f"slo.window_s must be positive, got {s.window_s}")
        s.burn_windows_s = tuple(float(w) for w in s.burn_windows_s)
        if not s.burn_windows_s or any(w <= 0 for w in s.burn_windows_s):
            raise ValueError(
                f"slo.burn_windows_s must be non-empty positive, got "
                f"{s.burn_windows_s}")
        s.burn_threshold = float(s.burn_threshold)
        if s.burn_threshold <= 0:
            raise ValueError(
                f"slo.burn_threshold must be positive, got "
                f"{s.burn_threshold}")
        return s

    @classmethod
    def coerce(cls, obj) -> "SLOConfig":
        """Accept None (disabled), a bool, a dict (writing the block is
        the opt-in, like ``prefix_cache``), or an SLOConfig."""
        if obj is None:
            return cls(enabled=False)
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, bool):
            return cls.from_dict({"enabled": obj}) if obj \
                else cls(enabled=False)
        if isinstance(obj, dict):
            d = dict(obj)
            d.setdefault("enabled", True)   # passing a block opts in
            if not d["enabled"]:
                return cls(enabled=False)
            return cls.from_dict(d)
        raise TypeError(
            f"slo must be a bool, dict or SLOConfig, got "
            f"{type(obj).__name__}")


@dataclasses.dataclass
class FaultsConfig:
    """Deterministic fault-injection block (robustness testing; see
    :mod:`deepspeed_tpu_torch.faults`).  ``rules`` is a list of rule dicts —
    ``{"subsystem": "aio_read", "rate": 0.5, "count": 3, ...}`` — each
    addressable by subsystem, firing rate, trigger count, skip-after
    offset, optional ``latency_s`` (mode "latency") and ``match``
    substring filter; ``seed`` makes the whole schedule reproducible.
    The serving engine builds a :class:`~deepspeed_tpu_torch.faults.
    FaultPlan` from the block and installs it process-wide for the
    aio/tier hook points; with the block off every hook is one branch.

    This is a TEST/CHAOS facility: never enable it on a production
    engine — the injected failures are real failures as far as the
    degradation machinery is concerned.
    """

    enabled: bool = False
    seed: int = 0
    rules: list = dataclasses.field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultsConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        f = cls(**{k: v for k, v in d.items() if k in known})
        f.seed = int(f.seed)
        if not isinstance(f.rules, (list, tuple)):
            raise ValueError(
                f"faults.rules must be a list of rule dicts, got "
                f"{type(f.rules).__name__}")
        f.rules = list(f.rules)
        if f.enabled:
            # deep-validate NOW (a bad rule must fail at config parse,
            # not at the first injection opportunity); the built plan
            # is thrown away — the engine builds its own
            from deepspeed_tpu_torch.faults import FaultPlan

            FaultPlan(f.rules, seed=f.seed)
        return f

    @classmethod
    def coerce(cls, obj) -> "FaultsConfig":
        """Accept None (disabled), a dict (writing the block is the
        opt-in, like ``kv_tier``), or a FaultsConfig."""
        if obj is None:
            return cls(enabled=False)
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, dict):
            d = dict(obj)
            d.setdefault("enabled", True)   # passing a block opts in
            return cls.from_dict(d)
        raise TypeError(
            f"faults must be a dict or FaultsConfig, got "
            f"{type(obj).__name__}")


@dataclasses.dataclass
class FleetConfig:
    """Replicated serving fleet block (the multi-replica front end;
    consumed by :class:`~deepspeed_tpu_torch.fleet.FleetRouter`).  A fleet spreads open-loop traffic across
    ``replicas`` in-process :class:`~deepspeed_tpu_torch.inference.serving.
    ServingEngine` replicas: routing is prefix-cache-affine when
    ``affinity`` is on (the router matches a prompt's chained page keys
    against each replica's published-key digest and sends the request
    where its prefix is warm) with least-loaded fallback; per-replica
    health (watchdog, degraded flags, kv-tier breaker, shed activity)
    feeds a HEALTHY → DEGRADED → QUARANTINED → DRAINING → DEAD state
    machine with hysteresis; a dead or fatally-stalled replica fails
    over — its queued and zero-token in-flight requests re-submit to
    survivors under ``retry_budget``, requests that already emitted
    tokens fail typed (never double-generate).

    ``quarantine_after``: consecutive degraded health polls before a
    DEGRADED replica stops receiving new admissions (QUARANTINED);
    ``recover_after``: consecutive healthy polls to step back one state
    (the hysteresis that stops flapping).  ``shed_queue_depth``: fleet-
    level admission shedding — aggregate queued requests across
    routable replicas at or past this depth return a typed
    ``RequestShed`` from ``submit`` (0 = off; per-replica
    ``shed_queue_depth`` still applies underneath).
    ``digest_refresh_steps``: router steps between published-key digest
    refreshes (the affinity lookup's staleness bound).
    ``fatal_stall_s``: a replica stalled longer than this is treated as
    dead (failover) rather than waited out.

    ``tp``: devices per replica on the ``model`` (tensor-parallel)
    axis.  The JAX package builds each replica over its own ``tp``-device
    model-axis mesh; in the port a TP replica is a group of
    ``torch.distributed`` processes, which the fleet does not build yet:
    :func:`~deepspeed_tpu_torch.fleet.fleet_router` raises
    ``NotImplementedError`` for ``tp > 1`` (ROADMAP A10's remainder).
    1 = classic unsharded replicas.

    ``roles``: disaggregated prefill/decode serving — a dict
    ``{"prefill": n, "decode": m}`` (n + m == replicas) splits the ring
    into a prefill-specialized pool and a decode-specialized pool.  New
    requests route to a prefill replica, run to first-token-ready
    state, publish their KV chain to the attached
    :class:`~deepspeed_tpu_torch.kv_fabric.KVFabric`, and a decode replica
    picks the request up as a migrated admission (the handoff charges
    no retry budget — it is scheduled movement).  Role preference
    degrades gracefully: when a role's pool has no routable replica,
    requests fall back to the other pool (every replica runs the full
    engine).  None = classic symmetric fleet.
    """

    replicas: int = 2
    tp: int = 1
    affinity: bool = True
    retry_budget: int = 2
    quarantine_after: int = 3
    recover_after: int = 2
    shed_queue_depth: int = 0
    digest_refresh_steps: int = 8
    fatal_stall_s: float = 5.0
    roles: Optional[Dict[str, int]] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FleetConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        f = cls(**{k: v for k, v in d.items() if k in known})
        f.replicas = int(f.replicas)
        if f.replicas < 1:
            raise ValueError(
                f"fleet.replicas must be >= 1, got {f.replicas}")
        f.affinity = bool(f.affinity)
        f.tp = int(f.tp)
        if f.tp < 1:
            raise ValueError(f"fleet.tp must be >= 1, got {f.tp}")
        if f.roles is not None:
            if not isinstance(f.roles, dict):
                raise ValueError(
                    f"fleet.roles must be a dict like "
                    f'{{"prefill": 1, "decode": 2}}, got '
                    f"{type(f.roles).__name__}")
            bad = set(f.roles) - {"prefill", "decode"}
            if bad:
                raise ValueError(
                    f"fleet.roles keys must be 'prefill'/'decode', got "
                    f"{sorted(bad)}")
            f.roles = {k: int(v) for k, v in f.roles.items()}
            if any(v < 1 for v in f.roles.values()):
                raise ValueError(
                    f"fleet.roles counts must be >= 1, got {f.roles} — "
                    "a role with zero replicas is the same as not "
                    "declaring it")
            if len(f.roles) != 2:
                raise ValueError(
                    f"fleet.roles needs BOTH a prefill and a decode "
                    f"pool, got {sorted(f.roles)} — one pool is just a "
                    "classic fleet")
            if sum(f.roles.values()) != f.replicas:
                raise ValueError(
                    f"fleet.roles counts {f.roles} sum to "
                    f"{sum(f.roles.values())} but fleet.replicas is "
                    f"{f.replicas} — every replica needs exactly one "
                    "role")
        f.retry_budget = int(f.retry_budget)
        if f.retry_budget < 0:
            raise ValueError(
                f"fleet.retry_budget must be >= 0, got {f.retry_budget}")
        for name, lo in (("quarantine_after", 1), ("recover_after", 1),
                         ("shed_queue_depth", 0),
                         ("digest_refresh_steps", 1)):
            v = int(getattr(f, name))
            setattr(f, name, v)
            if v < lo:
                raise ValueError(
                    f"fleet.{name} must be >= {lo}, got {v}")
        f.fatal_stall_s = float(f.fatal_stall_s)
        if f.fatal_stall_s <= 0:
            raise ValueError(
                f"fleet.fatal_stall_s must be positive, got "
                f"{f.fatal_stall_s}")
        return f

    @classmethod
    def coerce(cls, obj) -> "FleetConfig":
        """Accept None (defaults), an int (replica count), a dict, or a
        FleetConfig."""
        if obj is None:
            return cls()
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, int) and not isinstance(obj, bool):
            return cls.from_dict({"replicas": obj})
        if isinstance(obj, dict):
            return cls.from_dict(obj)
        raise TypeError(
            f"fleet must be an int, dict or FleetConfig, got "
            f"{type(obj).__name__}")


@dataclasses.dataclass
class FabricConfig:
    """Cross-replica KV fabric block (consumed by
    :class:`~deepspeed_tpu_torch.kv_fabric.KVFabric` and the
    :class:`~deepspeed_tpu_torch.fleet.FleetRouter` migration/handoff paths;
    ref: ZeRO-Infinity's checksummed host/NVMe transport,
    arXiv:2104.07857, re-targeted at serialized KV pages).

    The fabric is a shared, content-addressed exchange of serialized KV
    pages (same chained blake2b keys as the prefix cache, same
    per-buffer crc32 discipline as the spill tier — int8-quantized cold
    pages ride as-is).  On an affinity miss where another replica's
    digest covers the prompt, the router asks the owner to export the
    matching page chain into the fabric and the target admits it
    through the existing ``begin_promotion``/``TierPageReader`` path
    instead of re-prefilling; a checksum failure or a migration past
    ``migrate_timeout_s`` falls back to re-prefill exactly like a
    failed tier promotion.  Replicas participating in the fabric need
    the ``kv_tier`` block — the local spill pool is the admission side
    of the transport.

    ``capacity_bytes`` caps the exchange (oldest entries evict);
    ``min_pages`` is the smallest chain worth migrating (below it the
    re-prefill is cheaper than the bookkeeping).
    """

    enabled: bool = False
    capacity_bytes: int = 1 << 30
    migrate_timeout_s: float = 5.0
    min_pages: int = 1

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FabricConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        f = cls(**{k: v for k, v in d.items() if k in known})
        f.capacity_bytes = int(f.capacity_bytes)
        if f.capacity_bytes < 1:
            raise ValueError(
                f"fabric.capacity_bytes must be >= 1, got "
                f"{f.capacity_bytes}")
        f.migrate_timeout_s = float(f.migrate_timeout_s)
        if f.migrate_timeout_s <= 0:
            raise ValueError(
                f"fabric.migrate_timeout_s must be positive, got "
                f"{f.migrate_timeout_s}")
        f.min_pages = int(f.min_pages)
        if f.min_pages < 1:
            raise ValueError(
                f"fabric.min_pages must be >= 1, got {f.min_pages}")
        return f

    @classmethod
    def coerce(cls, obj) -> "FabricConfig":
        """Accept None (disabled), a bool, a dict (writing the block is
        the opt-in, like ``kv_tier``), or a FabricConfig."""
        if obj is None:
            return cls(enabled=False)
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, bool):
            return cls(enabled=obj)
        if isinstance(obj, dict):
            d = dict(obj)
            d.setdefault("enabled", True)   # passing a block opts in
            return cls.from_dict(d)
        raise TypeError(
            f"fabric must be a bool, dict or FabricConfig, got "
            f"{type(obj).__name__}")


@dataclasses.dataclass
class AutoscaleConfig:
    """Elastic-fleet autoscaling block (consumed by
    :class:`~deepspeed_tpu_torch.autoscale.FleetAutoscaler` over a
    :class:`~deepspeed_tpu_torch.fleet.FleetRouter`).  The autoscaler polls
    the control-plane signals the fleet already emits — mean queue
    depth per routable replica, shed activity since the last
    evaluation, and the max SLO burn rate across the fleet — every
    ``eval_interval_steps`` router steps, and drives scale-up (spawn a
    replica from the registered ``engine_factory``) and scale-down
    (``drain()`` → ``retire()``, warm digest handed to the affinity
    successor) between ``min_replicas`` and ``max_replicas``.

    Hysteresis + cooldown: pressure must persist for ``up_after``
    (resp. ``down_after``) consecutive evaluations before a scale
    event, and at least ``cooldown_s`` must separate events, so a
    burn-rate blip never flaps the fleet.

    ``cold_start="streamed"`` spawns new replicas in ZeRO-Inference
    streamed mode (serve immediately while weights page in from
    host/NVMe — arXiv:2104.07857) and promotes
    ``promote_layers_per_tick`` layers per autoscaler tick until the
    replica flips to fully resident; ``"resident"`` builds the classic
    engine (the factory decides what either means for its model).

    Rolling weight updates (``FleetAutoscaler.rollout``): the fleet is
    walked one replica at a time (drain → swap → rejoin), watching
    ``rollout_soak_steps`` ticks between replicas; if the NEW
    version's max burn rate exceeds ``rollback_burn_threshold`` with
    at least ``rollback_min_finished`` classified requests on it, the
    rollout halts and already-updated replicas roll back — an upgrade
    never drops or double-generates a request.
    """

    enabled: bool = False
    min_replicas: int = 1
    max_replicas: int = 4
    eval_interval_steps: int = 8
    scale_up_queue_depth: float = 4.0
    scale_up_burn: float = 1.0
    scale_up_on_shed: bool = True
    scale_down_queue_depth: float = 0.5
    up_after: int = 2
    down_after: int = 3
    cooldown_s: float = 5.0
    cold_start: str = "resident"
    promote_layers_per_tick: int = 1
    rollout_soak_steps: int = 2
    rollback_burn_threshold: float = 1.0
    rollback_min_finished: int = 1

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AutoscaleConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        a = cls(**{k: v for k, v in d.items() if k in known})
        a.enabled = bool(a.enabled)
        for name, lo in (("min_replicas", 1), ("max_replicas", 1),
                         ("eval_interval_steps", 1), ("up_after", 1),
                         ("down_after", 1),
                         ("promote_layers_per_tick", 1),
                         ("rollout_soak_steps", 0),
                         ("rollback_min_finished", 1)):
            v = int(getattr(a, name))
            setattr(a, name, v)
            if v < lo:
                raise ValueError(
                    f"autoscale.{name} must be >= {lo}, got {v}")
        if a.max_replicas < a.min_replicas:
            raise ValueError(
                f"autoscale.max_replicas {a.max_replicas} < "
                f"min_replicas {a.min_replicas}")
        for name in ("scale_up_queue_depth", "scale_down_queue_depth",
                     "scale_up_burn", "cooldown_s",
                     "rollback_burn_threshold"):
            v = float(getattr(a, name))
            setattr(a, name, v)
            if v < 0:
                raise ValueError(
                    f"autoscale.{name} must be >= 0, got {v}")
        if a.scale_down_queue_depth > a.scale_up_queue_depth:
            raise ValueError(
                f"autoscale.scale_down_queue_depth "
                f"{a.scale_down_queue_depth} > scale_up_queue_depth "
                f"{a.scale_up_queue_depth} — the band would scale up "
                "and down simultaneously")
        a.scale_up_on_shed = bool(a.scale_up_on_shed)
        if a.cold_start not in ("resident", "streamed"):
            raise ValueError(
                f"autoscale.cold_start must be 'resident' or "
                f"'streamed', got {a.cold_start!r}")
        return a

    @classmethod
    def coerce(cls, obj) -> "AutoscaleConfig":
        """Accept None (disabled), a dict (writing the block is the
        opt-in, like ``fleet``), or an AutoscaleConfig."""
        if obj is None:
            return cls(enabled=False)
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, dict):
            d = dict(obj)
            d.setdefault("enabled", True)   # passing a block opts in
            return cls.from_dict(d)
        raise TypeError(
            f"autoscale must be a dict or AutoscaleConfig, got "
            f"{type(obj).__name__}")


@dataclasses.dataclass
class TelemetryConfig:
    """Runtime telemetry block (no single reference analogue — it
    unifies the reference's monitor/comms-logger/flops-profiler
    surfaces behind one :class:`~deepspeed_tpu_torch.telemetry.
    MetricsRegistry`).

    ``enabled`` default-on keeps the registry live (counters/gauges/
    histograms recorded, readable via ``registry.snapshot()``) with NO
    exporter running — exporting only happens when a sink key is set.
    ``enabled: false`` swaps every metric for a shared no-op singleton:
    no lock, no ``perf_counter``, no ``TraceAnnotation`` on any hot
    path (the serving decode loop's disabled overhead is bounded in
    SERVING_OVERHEAD.json).
    """

    enabled: bool = True
    interval_s: float = 10.0             # min seconds between sink ticks
    prometheus_path: Optional[str] = None  # text exposition file (atomic)
    http_port: Optional[int] = None      # stdlib /metrics endpoint; 0=ephemeral
    monitor_bridge: bool = True          # fan into MonitorMaster when one is on
    step_sync: bool = False              # True: device-synced step timing + MFU
    #   (brackets each train step with the ThroughputTimer's
    #   block_until_ready — accurate device wall at ~2 tiny syncs/step;
    #   False keeps the training hot path sync-free and records host
    #   dispatch wall only)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TelemetryConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        t = cls(**{k: v for k, v in d.items() if k in known})
        if t.interval_s < 0:
            raise ValueError(
                f"telemetry.interval_s must be >= 0, got {t.interval_s}")
        if t.http_port is not None and not 0 <= int(t.http_port) < 65536:
            raise ValueError(
                f"telemetry.http_port must be 0..65535, got {t.http_port}")
        return t

    @classmethod
    def coerce(cls, obj) -> "TelemetryConfig":
        """Accept None (defaults), a bool (enable/disable), a dict, or
        a TelemetryConfig — the same loose contract the serving
        builders use for ``zero_inference``."""
        if obj is None:
            return cls()
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, bool):
            return cls(enabled=obj)
        if isinstance(obj, dict):
            return cls.from_dict(obj)
        raise TypeError(
            f"telemetry must be a bool, dict or TelemetryConfig, got "
            f"{type(obj).__name__}")


@dataclasses.dataclass
class TracingConfig:
    """Per-request tracing + flight-recorder block (no single reference
    analogue; the third observability pillar next to ``telemetry`` —
    per-request event timelines and hang postmortems, see
    :mod:`deepspeed_tpu_torch.request_trace`).

    Default-on: the recorder is a preallocated ring and each event is
    one clock read + one tuple store (bounded in
    ``SERVING_OVERHEAD.json`` ``tracing_overhead``), cheap enough to
    leave on in production so a hang always leaves a postmortem.
    ``sample_rate`` thins PER REQUEST (deterministic on the request id:
    0.1 traces every 10th request's full lifecycle, 0 disables —
    ``enabled: false`` and ``sample_rate: 0`` both hand out the shared
    no-op tracer).  ``ring_capacity`` bounds memory: overflow drops the
    OLDEST events (a postmortem wants the last seconds).  ``dump_dir``
    receives automatic flight-recorder dumps on ``Watchdog`` timeout,
    unhandled exception (``install_excepthook``), or ``SIGUSR1``
    (``sigusr1``).
    """

    enabled: bool = True
    sample_rate: float = 1.0             # per-request; 0 = off
    ring_capacity: int = 65536           # events kept (newest win)
    dump_dir: str = temp_path("dstpu_flight")  # postmortem dump target
    install_excepthook: bool = False     # chain sys.excepthook → dump
    sigusr1: bool = False                # SIGUSR1 → dump (live probe)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TracingConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        t = cls(**{k: v for k, v in d.items() if k in known})
        # store the coerced values, not just validate through the cast:
        # string-sourced configs (env/YAML) must not survive as strings
        t.sample_rate = float(t.sample_rate)
        t.ring_capacity = int(t.ring_capacity)
        if not 0.0 <= t.sample_rate <= 1.0:
            raise ValueError(
                f"tracing.sample_rate must be in [0, 1], got "
                f"{t.sample_rate}")
        if t.ring_capacity < 1:
            raise ValueError(
                f"tracing.ring_capacity must be >= 1, got "
                f"{t.ring_capacity}")
        return t

    @classmethod
    def coerce(cls, obj) -> "TracingConfig":
        """Accept None (defaults), a bool, a dict, or a TracingConfig —
        the same loose contract as ``telemetry``."""
        if obj is None:
            return cls()
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, bool):
            return cls(enabled=obj)
        if isinstance(obj, dict):
            return cls.from_dict(obj)
        raise TypeError(
            f"tracing must be a bool, dict or TracingConfig, got "
            f"{type(obj).__name__}")


@dataclasses.dataclass
class HistoryConfig:
    """Time-series metric history block (no reference analogue; the
    fourth observability pillar next to ``telemetry``/``tracing``/
    ``slo`` — retained trajectories instead of point-in-time gauges,
    see :mod:`deepspeed_tpu_torch.history`).

    Multi-resolution ring buffers over the engine's registry, sampled
    on the :class:`~deepspeed_tpu_torch.telemetry.TelemetryExporter` tick —
    never the decode hot path.  ``rings`` is a tuple of
    ``(period_s, samples)`` pairs (default: 1 s × 120 plus 10 s × 360 —
    two minutes fine, one hour coarse, fixed memory).  Counters record
    as RATES (reset-tolerant), gauges as last value, histograms as
    p50/p95 of the samples landed since the previous tick.
    ``sample_interval_s`` sets the tick cadence; ``metrics`` restricts
    the tracked names (None = every registry metric, bounded by
    ``max_series``); ``max_annotations`` bounds the event-annotation
    ring (autoscaler scale/rollout marks).
    """

    enabled: bool = False
    sample_interval_s: float = 1.0       # tick cadence (exporter-driven)
    rings: tuple = ((1.0, 120), (10.0, 360))   # (period_s, samples)
    metrics: Optional[tuple] = None      # None = all registry metrics
    max_series: int = 256                # hard cap on tracked series
    max_annotations: int = 256           # scale/rollout marks kept

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "HistoryConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        h = cls(**{k: v for k, v in d.items() if k in known})
        h.sample_interval_s = float(h.sample_interval_s)
        if h.sample_interval_s <= 0:
            raise ValueError(
                f"history.sample_interval_s must be positive, got "
                f"{h.sample_interval_s}")
        rings = tuple((float(p), int(n)) for p, n in h.rings)
        if not rings or any(p <= 0 or n < 1 for p, n in rings):
            raise ValueError(
                f"history.rings must be non-empty (period_s > 0, "
                f"samples >= 1) pairs, got {h.rings}")
        if list(p for p, _ in rings) != sorted(set(p for p, _ in rings)):
            raise ValueError(
                f"history.rings periods must be strictly increasing, "
                f"got {h.rings}")
        h.rings = rings
        if h.metrics is not None:
            h.metrics = tuple(str(m) for m in h.metrics)
        h.max_series = int(h.max_series)
        h.max_annotations = int(h.max_annotations)
        if h.max_series < 1 or h.max_annotations < 1:
            raise ValueError(
                "history.max_series and history.max_annotations must "
                f"be >= 1, got {h.max_series}/{h.max_annotations}")
        return h

    @classmethod
    def coerce(cls, obj) -> "HistoryConfig":
        """Accept None (disabled), a bool, a dict (writing the block is
        the opt-in, like ``slo``), or a HistoryConfig."""
        if obj is None:
            return cls(enabled=False)
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, bool):
            return cls.from_dict({"enabled": obj}) if obj \
                else cls(enabled=False)
        if isinstance(obj, dict):
            d = dict(obj)
            d.setdefault("enabled", True)   # passing a block opts in
            if not d["enabled"]:
                return cls(enabled=False)
            return cls.from_dict(d)
        raise TypeError(
            f"history must be a bool, dict or HistoryConfig, got "
            f"{type(obj).__name__}")


@dataclasses.dataclass
class IncidentsConfig:
    """Incident-capture block (no reference analogue; the black-box
    flight recorder's trip logic — see
    :mod:`deepspeed_tpu_torch.incidents`).

    An :class:`~deepspeed_tpu_torch.incidents.IncidentManager` subscribes to
    the structured events the stack already emits (``slo_burn_alert``,
    KV-tier promotion failures, replica failover, rollout rollbacks,
    watchdog fires, shed storms) plus lightweight EWMA z-score
    detectors over ``detect`` history series, and on a trip captures an
    atomic JSON **incident bundle** into ``dir``: the triggering event,
    ``pre_window_s`` of metric history, the last ``ring_events``
    flight-recorder events around t0, and the /statusz + SLO snapshot.
    ``dedup_window_s`` rate-limits per incident class (a burn storm
    yields one bundle, not hundreds) and ``max_bundles`` caps bundles
    per process.  ``shed_storm_threshold`` sheds per evaluation tick
    that count as a storm (0 disables the storm trigger);
    ``z_threshold``/``ewma_alpha``/``min_samples`` tune the anomaly
    detectors, evaluated every ``eval_interval_s``.
    """

    enabled: bool = False
    dir: str = temp_path("dstpu_incidents")  # bundle output directory
    pre_window_s: float = 60.0           # history window in the bundle
    dedup_window_s: float = 30.0         # per-class rate limit
    max_bundles: int = 16                # per-process bundle cap
    ring_events: int = 256               # flight-recorder slice size
    # history series for the EWMA z detectors: None = the consumer's
    # defaults (engines watch TTFT p95 + per-tier goodput); an
    # EXPLICIT empty list disables the detectors — with
    # shed_storm_threshold 0 that arms only the hard triggers
    detect: Optional[tuple] = None
    z_threshold: float = 4.0             # |z| trip bound
    ewma_alpha: float = 0.2              # EWMA smoothing factor
    min_samples: int = 12                # warmup before a z can trip
    eval_interval_s: float = 1.0         # detector/evaluation cadence
    shed_storm_threshold: int = 8        # sheds/tick = storm; 0 = off

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "IncidentsConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        c = cls(**{k: v for k, v in d.items() if k in known})
        for name in ("pre_window_s", "dedup_window_s", "z_threshold",
                     "ewma_alpha", "eval_interval_s"):
            setattr(c, name, float(getattr(c, name)))
        for name in ("max_bundles", "ring_events", "min_samples",
                     "shed_storm_threshold"):
            setattr(c, name, int(getattr(c, name)))
        if c.pre_window_s <= 0 or c.eval_interval_s <= 0:
            raise ValueError(
                "incidents.pre_window_s and incidents.eval_interval_s "
                f"must be positive, got {c.pre_window_s}/"
                f"{c.eval_interval_s}")
        if c.dedup_window_s < 0 or c.shed_storm_threshold < 0:
            raise ValueError(
                "incidents.dedup_window_s and "
                "incidents.shed_storm_threshold must be >= 0, got "
                f"{c.dedup_window_s}/{c.shed_storm_threshold}")
        if c.max_bundles < 1 or c.ring_events < 1 or c.min_samples < 1:
            raise ValueError(
                "incidents.max_bundles, incidents.ring_events and "
                "incidents.min_samples must be >= 1, got "
                f"{c.max_bundles}/{c.ring_events}/{c.min_samples}")
        if not 0.0 < c.ewma_alpha <= 1.0:
            raise ValueError(
                f"incidents.ewma_alpha must be in (0, 1], got "
                f"{c.ewma_alpha}")
        if c.z_threshold <= 0:
            raise ValueError(
                f"incidents.z_threshold must be positive, got "
                f"{c.z_threshold}")
        if c.detect is not None:
            c.detect = tuple(str(s) for s in c.detect)
        return c

    @classmethod
    def coerce(cls, obj) -> "IncidentsConfig":
        """Accept None (disabled), a bool, a dict (writing the block is
        the opt-in, like ``history``), or an IncidentsConfig."""
        if obj is None:
            return cls(enabled=False)
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, bool):
            return cls.from_dict({"enabled": obj}) if obj \
                else cls(enabled=False)
        if isinstance(obj, dict):
            d = dict(obj)
            d.setdefault("enabled", True)   # passing a block opts in
            if not d["enabled"]:
                return cls(enabled=False)
            return cls.from_dict(d)
        raise TypeError(
            f"incidents must be a bool, dict or IncidentsConfig, got "
            f"{type(obj).__name__}")


@dataclasses.dataclass
class DevprofConfig:
    """Device-truth observability block (no reference analogue; the
    fifth observability pillar next to ``telemetry``/``tracing``/
    ``history``/``incidents`` — see :mod:`deepspeed_tpu_torch.devprof`).

    Three coupled capabilities: a **compile sentinel** (every XLA
    compile attributed to a call-site ledger, split warmup vs
    steady-state — a steady-state recompile is a contract violation
    and trips an incident), **per-phase device-time attribution**
    (sampled ``block_until_ready`` deltas on a ``sample_rate``
    cadence feeding ``devprof_device_seconds{phase}`` counters plus a
    host-vs-device gap gauge), and **roofline accounting** (one-time
    ``cost_analysis`` of the compiled sweep programs at engine build
    combined with sampled device time into live MFU/MBU gauges).
    ``sample_rate`` thins PER DISPATCH deterministically (0.05 times
    one dispatch in 20 per phase; 0 disables the sync entirely);
    ``capture_max_s`` caps on-demand ``/profilez?capture_s=`` device
    traces (written under ``tracing.dump_dir``); ``cost_analysis``
    gates the build-time roofline pass (the only part that touches
    XLA's cost model).
    """

    enabled: bool = False
    sample_rate: float = 0.05            # per-dispatch; 0 = no syncs
    capture_max_s: float = 10.0          # /profilez duration cap
    cost_analysis: bool = True           # roofline pass at build

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DevprofConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        c = cls(**{k: v for k, v in d.items() if k in known})
        c.sample_rate = float(c.sample_rate)
        c.capture_max_s = float(c.capture_max_s)
        c.cost_analysis = bool(c.cost_analysis)
        if not 0.0 <= c.sample_rate <= 1.0:
            raise ValueError(
                f"devprof.sample_rate must be in [0, 1], got "
                f"{c.sample_rate}")
        if c.capture_max_s <= 0:
            raise ValueError(
                f"devprof.capture_max_s must be positive, got "
                f"{c.capture_max_s}")
        return c

    @classmethod
    def coerce(cls, obj) -> "DevprofConfig":
        """Accept None (disabled), a bool, a dict (writing the block is
        the opt-in, like ``history``), or a DevprofConfig."""
        if obj is None:
            return cls(enabled=False)
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, bool):
            return cls.from_dict({"enabled": obj}) if obj \
                else cls(enabled=False)
        if isinstance(obj, dict):
            d = dict(obj)
            d.setdefault("enabled", True)   # passing a block opts in
            if not d["enabled"]:
                return cls(enabled=False)
            return cls.from_dict(d)
        raise TypeError(
            f"devprof must be a bool, dict or DevprofConfig, got "
            f"{type(obj).__name__}")


@dataclasses.dataclass
class ObsWireConfig:
    """Remote observability wire block (no reference analogue; see
    :mod:`deepspeed_tpu_torch.obs_wire`).

    Governs the **scrape plane**: `RemoteReplica` pollers that read a
    replica's ``/statusz``/``/metrics``/``/historyz``/``/tracez`` HTTP
    surface from another process and fold the snapshots into the fleet
    rollups. ``poll_interval_s`` paces the scrape loop; ``timeout_s``
    bounds each HTTP request; ``retries``/``backoff_s`` drive
    :func:`~deepspeed_tpu_torch.faults.retry_with_backoff` around each
    scrape. Staleness hysteresis: a replica whose last successful
    scrape is older than ``stale_after_s`` reads STALE, older than
    ``lost_after_s`` reads LOST (last-known snapshot retained either
    way); ``fresh_after`` consecutive successful scrapes are required
    to return to FRESH. ``offset_probes`` sets the min-RTT sample
    count for the cross-process clock-offset estimator used when
    merging ``/tracez`` segments.
    """

    enabled: bool = False
    poll_interval_s: float = 1.0         # scrape loop cadence
    timeout_s: float = 2.0               # per-HTTP-request budget
    retries: int = 2                     # attempts per scrape
    backoff_s: float = 0.05              # retry backoff base (doubles)
    stale_after_s: float = 5.0           # last-ok age => STALE
    lost_after_s: float = 15.0           # last-ok age => LOST
    fresh_after: int = 2                 # ok scrapes to re-enter FRESH
    offset_probes: int = 8               # min-RTT clock-offset samples

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ObsWireConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        c = cls(**{k: v for k, v in d.items() if k in known})
        c.poll_interval_s = float(c.poll_interval_s)
        c.timeout_s = float(c.timeout_s)
        c.retries = int(c.retries)
        c.backoff_s = float(c.backoff_s)
        c.stale_after_s = float(c.stale_after_s)
        c.lost_after_s = float(c.lost_after_s)
        c.fresh_after = int(c.fresh_after)
        c.offset_probes = int(c.offset_probes)
        if c.poll_interval_s <= 0 or c.timeout_s <= 0:
            raise ValueError(
                f"obs_wire.poll_interval_s and obs_wire.timeout_s must "
                f"be positive, got {c.poll_interval_s}/{c.timeout_s}")
        if c.retries < 1 or c.fresh_after < 1 or c.offset_probes < 1:
            raise ValueError(
                f"obs_wire.retries, obs_wire.fresh_after and "
                f"obs_wire.offset_probes must be >= 1, got "
                f"{c.retries}/{c.fresh_after}/{c.offset_probes}")
        if c.backoff_s < 0:
            raise ValueError(
                f"obs_wire.backoff_s must be >= 0, got {c.backoff_s}")
        if not 0 < c.stale_after_s <= c.lost_after_s:
            raise ValueError(
                f"obs_wire requires 0 < stale_after_s <= lost_after_s, "
                f"got {c.stale_after_s}/{c.lost_after_s}")
        return c

    @classmethod
    def coerce(cls, obj) -> "ObsWireConfig":
        """Accept None (disabled), a bool, a dict (writing the block is
        the opt-in, like ``history``), or an ObsWireConfig."""
        if obj is None:
            return cls(enabled=False)
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, bool):
            return cls.from_dict({"enabled": obj}) if obj \
                else cls(enabled=False)
        if isinstance(obj, dict):
            d = dict(obj)
            d.setdefault("enabled", True)   # passing a block opts in
            if not d["enabled"]:
                return cls(enabled=False)
            return cls.from_dict(d)
        raise TypeError(
            f"obs_wire must be a bool, dict or ObsWireConfig, got "
            f"{type(obj).__name__}")


@dataclasses.dataclass
class TransportConfig:
    """Process-boundary transport block (no reference analogue; see
    :mod:`deepspeed_tpu_torch.transport`).

    Selects and sizes the byte mover under one parent<->child
    peer-pair.  ``kind``: ``"shm"`` (file-backed mmap ring pair,
    same-host only), ``"tcp"`` (length-prefixed stream, the general
    path), or ``"auto"`` — shm when the peer is known same-host, tcp
    otherwise.  ``slot_bytes``/``ring_slots`` size each shm ring
    (per-frame capacity is ``ring_slots * (slot_bytes - 24)``; a
    larger frame errors rather than wedging).  ``io_timeout_s``
    bounds one send/recv; ``rpc_timeout_s`` bounds one full
    request/reply round trip.  ``connect_attempts``/``backoff_s``
    drive :func:`~deepspeed_tpu_torch.faults.retry_with_backoff` around
    dialing and re-dialing a TCP peer.
    """

    kind: str = "auto"                   # shm | tcp | auto
    slot_bytes: int = 1 << 14            # shm slot size (incl. 24B hdr)
    ring_slots: int = 64                 # slots per shm direction
    io_timeout_s: float = 5.0            # one send/recv bound
    rpc_timeout_s: float = 10.0          # one request/reply bound
    connect_attempts: int = 5            # TCP dial/redial attempts
    backoff_s: float = 0.05              # redial backoff base (doubles)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TransportConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        c = cls(**{k: v for k, v in d.items() if k in known})
        c.kind = str(c.kind)
        c.slot_bytes = int(c.slot_bytes)
        c.ring_slots = int(c.ring_slots)
        c.io_timeout_s = float(c.io_timeout_s)
        c.rpc_timeout_s = float(c.rpc_timeout_s)
        c.connect_attempts = int(c.connect_attempts)
        c.backoff_s = float(c.backoff_s)
        if c.kind not in ("shm", "tcp", "auto"):
            raise ValueError(
                f"transport.kind must be shm|tcp|auto, got {c.kind!r}")
        if c.slot_bytes < 64:
            raise ValueError(
                f"transport.slot_bytes must be >= 64, got {c.slot_bytes}")
        if c.ring_slots < 2:
            raise ValueError(
                f"transport.ring_slots must be >= 2, got {c.ring_slots}")
        if c.io_timeout_s <= 0 or c.rpc_timeout_s <= 0:
            raise ValueError(
                f"transport.io_timeout_s and transport.rpc_timeout_s "
                f"must be positive, got "
                f"{c.io_timeout_s}/{c.rpc_timeout_s}")
        if c.connect_attempts < 1:
            raise ValueError(
                f"transport.connect_attempts must be >= 1, got "
                f"{c.connect_attempts}")
        if c.backoff_s < 0:
            raise ValueError(
                f"transport.backoff_s must be >= 0, got {c.backoff_s}")
        return c

    @classmethod
    def coerce(cls, obj) -> "TransportConfig":
        """Accept None (defaults), a dict, or a TransportConfig — the
        block tunes an always-on plane, so there is no enabled flag."""
        if obj is None:
            return cls()
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, dict):
            return cls.from_dict(obj)
        raise TypeError(
            f"transport must be a dict or TransportConfig, got "
            f"{type(obj).__name__}")


@dataclasses.dataclass
class ProcFleetConfig:
    """Out-of-process fleet block (no reference analogue; see
    :mod:`deepspeed_tpu_torch.proc_fleet`).

    Governs how :func:`~deepspeed_tpu_torch.proc_fleet.proc_fleet_router`
    spawns and supervises child replica processes.  ``replicas``
    counts children; ``spawn_timeout_s`` bounds one child's
    build-engine-and-handshake window; ``health_cache_s`` is the
    staleness bound on the proxy's cached child health (an expired
    cache turns the next ``healthz()`` into a real RPC — the SIGKILL
    detection cadence); ``poll_timeout_s`` bounds one router-step
    poll RPC; ``shutdown_grace_s`` is how long SIGTERM gets before
    SIGKILL at teardown.  ``attach_scrape`` additionally attaches
    each child's HTTP wire surface as a :class:`~deepspeed_tpu_torch.
    obs_wire.RemoteReplica` so the scrape plane (staleness
    walk, trace merge) observes the same processes the data plane
    drives.
    """

    replicas: int = 2
    spawn_timeout_s: float = 120.0
    health_cache_s: float = 0.25
    poll_timeout_s: float = 10.0
    shutdown_grace_s: float = 5.0
    attach_scrape: bool = False

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ProcFleetConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        c = cls(**{k: v for k, v in d.items() if k in known})
        c.replicas = int(c.replicas)
        c.spawn_timeout_s = float(c.spawn_timeout_s)
        c.health_cache_s = float(c.health_cache_s)
        c.poll_timeout_s = float(c.poll_timeout_s)
        c.shutdown_grace_s = float(c.shutdown_grace_s)
        c.attach_scrape = bool(c.attach_scrape)
        if c.replicas < 1:
            raise ValueError(
                f"proc_fleet.replicas must be >= 1, got {c.replicas}")
        if c.spawn_timeout_s <= 0 or c.poll_timeout_s <= 0:
            raise ValueError(
                f"proc_fleet.spawn_timeout_s and "
                f"proc_fleet.poll_timeout_s must be positive, got "
                f"{c.spawn_timeout_s}/{c.poll_timeout_s}")
        if c.health_cache_s < 0 or c.shutdown_grace_s < 0:
            raise ValueError(
                f"proc_fleet.health_cache_s and "
                f"proc_fleet.shutdown_grace_s must be >= 0, got "
                f"{c.health_cache_s}/{c.shutdown_grace_s}")
        return c

    @classmethod
    def coerce(cls, obj) -> "ProcFleetConfig":
        """Accept None (defaults), a dict, or a ProcFleetConfig."""
        if obj is None:
            return cls()
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, dict):
            return cls.from_dict(obj)
        raise TypeError(
            f"proc_fleet must be a dict or ProcFleetConfig, got "
            f"{type(obj).__name__}")


@dataclasses.dataclass
class PrecisionConfig:
    """ref: deepspeed/runtime/fp16/loss_scaler.py + config fp16/bf16 blocks."""

    dtype: str = "bfloat16"              # compute dtype: float32|bfloat16|float16
    master_dtype: str = "float32"        # master-weight / optimizer dtype
    # fp16 dynamic loss scaling (parity with ref; bf16 needs none)
    loss_scale: float = 0.0              # 0 => dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    min_loss_scale: float = 1.0

    @property
    def is_fp16(self) -> bool:
        return self.dtype == "float16"


@dataclasses.dataclass
class MeshConfig:
    """TPU topology block (no reference analogue: replaces process groups).

    Axis sizes; -1 on ``data`` means "all remaining devices".
    """

    pipe: int = 1
    data: int = -1
    expert: int = 1
    seq: int = 1
    model: int = 1

    def axis_sizes(self, n_devices: int) -> Dict[str, int]:
        sizes = {"pipe": self.pipe, "data": self.data, "expert": self.expert,
                 "seq": self.seq, "model": self.model}
        fixed = 1
        for k, v in sizes.items():
            if v != -1:
                if v < 1:
                    raise ValueError(f"mesh.{k} must be >=1 or -1, got {v}")
                fixed *= v
        n_auto = sum(1 for v in sizes.values() if v == -1)
        if n_auto > 1:
            raise ValueError("only one mesh axis may be -1")
        if n_auto == 1:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"device count {n_devices} not divisible by fixed mesh product {fixed}")
            auto = n_devices // fixed
            sizes = {k: (auto if v == -1 else v) for k, v in sizes.items()}
        total = 1
        for v in sizes.values():
            total *= v
        if total != n_devices:
            raise ValueError(
                f"mesh product {total} != device count {n_devices}: {sizes}")
        return sizes


@dataclasses.dataclass
class OptimizerConfig:
    """ref: config ``optimizer`` block (deepspeed/runtime/config.py)."""

    type: str = "adamw"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SchedulerConfig:
    """ref: config ``scheduler`` block → deepspeed/runtime/lr_schedules.py."""

    type: Optional[str] = None
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ActivationCheckpointingConfig:
    """ref: deepspeed/runtime/activation_checkpointing/config.py."""

    # none | full | save_dots | save_dots_no_batch | save_attn |
    # offload_attn | offload_dots_no_batch (see remat.policy)
    policy: str = "none"
    partition_activations: bool = False  # accepted; GSPMD shards activations
    # ref cpu_checkpointing: saved activations live in host RAM between
    # fwd and bwd — maps to the offload_attn policy unless an explicit
    # offload_* policy is already chosen
    cpu_checkpointing: bool = False


@dataclasses.dataclass
class PipelineConfig:
    """ref: deepspeed/runtime/pipe/config — schedule + microbatching."""

    stages: int = 1
    schedule: str = "1f1b"   # gpipe | 1f1b
    # layer→stage assignment; "uniform" splits the layer stack evenly
    partition_method: str = "uniform"


@dataclasses.dataclass
class MoEConfig:
    """ref: deepspeed/moe/layer.py constructor args."""

    enabled: bool = False
    num_experts: int = 1
    top_k: int = 2
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    min_capacity: int = 4
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 0.001


@dataclasses.dataclass
class Config:
    """Top-level parsed config (ref: deepspeed/runtime/config.py

    ``DeepSpeedConfig``).  ``Config.from_dict`` accepts the reference's JSON
    schema; batch arithmetic validation matches the reference's
    ``_batch_assertion``: train_batch == micro_batch * grad_accum * dp_world.
    """

    train_batch_size: Optional[int] = None
    train_micro_batch_size_per_gpu: Optional[int] = None
    gradient_accumulation_steps: Optional[int] = None
    gradient_clipping: float = 0.0
    steps_per_print: int = 10
    seed: int = 42
    zero: ZeroConfig = dataclasses.field(default_factory=ZeroConfig)
    precision: PrecisionConfig = dataclasses.field(default_factory=PrecisionConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    activation_checkpointing: ActivationCheckpointingConfig = dataclasses.field(
        default_factory=ActivationCheckpointingConfig)
    pipeline: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)
    moe: MoEConfig = dataclasses.field(default_factory=MoEConfig)
    elasticity: Optional[Any] = None  # ElasticityConfig when enabled
    curriculum: Optional[Any] = None  # CurriculumConfig when enabled
    random_ltd: Optional[Any] = None  # RandomLTDConfig when enabled
    progressive_layer_drop: Optional[Dict[str, Any]] = None
    eigenvalue: Optional[Dict[str, Any]] = None
    sparse_attention: Optional[Dict[str, Any]] = None
    zero_inference: ZeroInferenceConfig = dataclasses.field(
        default_factory=ZeroInferenceConfig)
    prefix_cache: PrefixCacheConfig = dataclasses.field(
        default_factory=PrefixCacheConfig)
    kv_tier: KVTierConfig = dataclasses.field(
        default_factory=KVTierConfig)
    kernels: KernelsConfig = dataclasses.field(
        default_factory=KernelsConfig)
    comm: CommConfig = dataclasses.field(
        default_factory=CommConfig)
    speculative: SpeculativeConfig = dataclasses.field(
        default_factory=SpeculativeConfig)
    slo: SLOConfig = dataclasses.field(default_factory=SLOConfig)
    faults: FaultsConfig = dataclasses.field(
        default_factory=FaultsConfig)
    fleet: FleetConfig = dataclasses.field(default_factory=FleetConfig)
    fabric: FabricConfig = dataclasses.field(
        default_factory=FabricConfig)
    autoscale: AutoscaleConfig = dataclasses.field(
        default_factory=AutoscaleConfig)
    telemetry: TelemetryConfig = dataclasses.field(
        default_factory=TelemetryConfig)
    tracing: TracingConfig = dataclasses.field(
        default_factory=TracingConfig)
    history: HistoryConfig = dataclasses.field(
        default_factory=HistoryConfig)
    incidents: IncidentsConfig = dataclasses.field(
        default_factory=IncidentsConfig)
    devprof: DevprofConfig = dataclasses.field(
        default_factory=DevprofConfig)
    obs_wire: ObsWireConfig = dataclasses.field(
        default_factory=ObsWireConfig)
    raw: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # ---------------------------------------------------------------- parse
    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        c = cls(raw=dict(d))
        c.train_batch_size = d.get(TRAIN_BATCH_SIZE)
        c.train_micro_batch_size_per_gpu = d.get(MICRO_BATCH)
        c.gradient_accumulation_steps = d.get(GRAD_ACCUM)
        c.gradient_clipping = float(d.get("gradient_clipping", 0.0))
        c.steps_per_print = int(d.get("steps_per_print", 10))
        c.seed = int(d.get("seed", 42))

        if "zero_optimization" in d:
            c.zero = ZeroConfig.from_dict(d["zero_optimization"])

        fp16 = d.get("fp16", {})
        bf16 = d.get("bf16", d.get("bfloat16", {}))
        if fp16.get("enabled"):
            c.precision = PrecisionConfig(
                dtype="float16",
                loss_scale=float(fp16.get("loss_scale", 0.0)),
                initial_scale_power=int(fp16.get("initial_scale_power", 16)),
                loss_scale_window=int(fp16.get("loss_scale_window", 1000)),
                hysteresis=int(fp16.get("hysteresis", 2)),
                min_loss_scale=float(fp16.get("min_loss_scale", 1.0)),
            )
        elif bf16.get("enabled", True):
            # bf16 is the TPU-native default (MXU-friendly).
            c.precision = PrecisionConfig(dtype="bfloat16")
        else:
            c.precision = PrecisionConfig(dtype="float32")

        if "mesh" in d:
            known = {f.name for f in dataclasses.fields(MeshConfig)}
            c.mesh = MeshConfig(**{k: v for k, v in d["mesh"].items() if k in known})
        if "optimizer" in d:
            c.optimizer = OptimizerConfig(
                type=str(d["optimizer"].get("type", "adamw")).lower(),
                params=dict(d["optimizer"].get("params", {})),
            )
        if "scheduler" in d:
            c.scheduler = SchedulerConfig(
                type=d["scheduler"].get("type"),
                params=dict(d["scheduler"].get("params", {})),
            )
        if "activation_checkpointing" in d:
            ac = d["activation_checkpointing"]
            pol = ac.get("policy", "full" if ac.get("enabled") else "none")
            cpu_ckpt = bool(ac.get("cpu_checkpointing", False))
            # cpu_checkpointing is a MODIFIER (ref semantics): it moves
            # saved activations to host only when checkpointing is on —
            # it never enables checkpointing by itself
            if cpu_ckpt and pol != "none" and not pol.startswith("offload"):
                pol = "offload_attn"
            c.activation_checkpointing = ActivationCheckpointingConfig(
                policy=pol,
                partition_activations=bool(ac.get("partition_activations", False)),
                cpu_checkpointing=cpu_ckpt,
            )
        if "pipeline" in d:
            known = {f.name for f in dataclasses.fields(PipelineConfig)}
            c.pipeline = PipelineConfig(
                **{k: v for k, v in d["pipeline"].items() if k in known})
        if "moe" in d:
            known = {f.name for f in dataclasses.fields(MoEConfig)}
            c.moe = MoEConfig(**{k: v for k, v in d["moe"].items() if k in known})
            c.moe.enabled = c.moe.enabled or c.moe.num_experts > 1
        if d.get("elasticity", {}).get("enabled"):
            from deepspeed_tpu_torch.elasticity import ElasticityConfig

            c.elasticity = ElasticityConfig.from_dict(d["elasticity"])
        # Data-efficiency blocks: accept both the reference's legacy
        # top-level "curriculum_learning" key and the nested
        # "data_efficiency" schema (ref: deepspeed/runtime/data_pipeline/
        # config.py get_data_efficiency_config).
        de = d.get("data_efficiency", {})
        cl = (de.get("data_sampling", {}).get("curriculum_learning")
              or d.get("curriculum_learning"))
        if cl and cl.get("enabled"):
            from deepspeed_tpu_torch.data.curriculum import CurriculumConfig

            c.curriculum = CurriculumConfig.from_dict(cl)
        rltd = de.get("data_routing", {}).get("random_ltd") or d.get("random_ltd")
        if rltd and rltd.get("enabled"):
            raise NotImplementedError(
                "random_ltd comes with random_ltd.py (ROADMAP A11)")
        if d.get("progressive_layer_drop", {}).get("enabled"):
            c.progressive_layer_drop = dict(d["progressive_layer_drop"])
        if d.get("eigenvalue", {}).get("enabled"):
            c.eigenvalue = dict(d["eigenvalue"])
        if d.get("sparse_attention"):
            c.sparse_attention = dict(d["sparse_attention"])
        if "zero_inference" in d:
            # coerce, not from_dict: WRITING the block is the opt-in
            # (same contract as serving_engine(zero_inference={...})) —
            # a user configuring tier/budget but omitting "enabled"
            # must never be silently served fully resident; an explicit
            # "enabled": false still disables
            c.zero_inference = ZeroInferenceConfig.coerce(
                d["zero_inference"])
        if "prefix_cache" in d:
            # coerce, not from_dict: writing the block IS the opt-in
            # (same contract as zero_inference above); an explicit
            # "enabled": false still disables
            c.prefix_cache = PrefixCacheConfig.coerce(d["prefix_cache"])
        if "kv_tier" in d:
            # coerce, not from_dict: writing the block IS the opt-in
            # (same contract as prefix_cache above); an explicit
            # "enabled": false still disables
            c.kv_tier = KVTierConfig.coerce(d["kv_tier"])
        if "kernels" in d:
            # no enabled switch here: "auto" is the default policy and
            # writing the block just overrides fields of it
            c.kernels = KernelsConfig.coerce(d["kernels"])
        if "comm" in d:
            # no enabled switch (same contract as kernels): the
            # defaults are the policy, the block overrides fields
            c.comm = CommConfig.coerce(d["comm"])
        if "speculative" in d:
            # coerce, not from_dict: writing the block IS the opt-in
            # (same contract as zero_inference / prefix_cache above);
            # an explicit "enabled": false still disables
            c.speculative = SpeculativeConfig.coerce(d["speculative"])
        if "slo" in d:
            # coerce, not from_dict: writing the block IS the opt-in
            # (same contract as prefix_cache / speculative above); an
            # explicit "enabled": false still disables
            c.slo = SLOConfig.coerce(d["slo"])
        if "faults" in d:
            # coerce, not from_dict: writing the block IS the opt-in
            # (same contract as kv_tier / slo above); an explicit
            # "enabled": false still disables
            c.faults = FaultsConfig.coerce(d["faults"])
        if "fleet" in d:
            c.fleet = FleetConfig.coerce(d["fleet"])
        if "fabric" in d:
            # coerce, not from_dict: writing the block IS the opt-in
            c.fabric = FabricConfig.coerce(d["fabric"])
        if "autoscale" in d:
            # coerce, not from_dict: writing the block IS the opt-in
            # (same contract as faults / slo above); an explicit
            # "enabled": false still disables
            c.autoscale = AutoscaleConfig.coerce(d["autoscale"])
        if "telemetry" in d:
            c.telemetry = TelemetryConfig.coerce(d["telemetry"])
        if "tracing" in d:
            c.tracing = TracingConfig.coerce(d["tracing"])
        if "history" in d:
            # coerce, not from_dict: writing the block IS the opt-in
            # (same contract as slo / faults above); an explicit
            # "enabled": false still disables
            c.history = HistoryConfig.coerce(d["history"])
        if "incidents" in d:
            # coerce, not from_dict: writing the block IS the opt-in
            c.incidents = IncidentsConfig.coerce(d["incidents"])
        if "devprof" in d:
            # coerce, not from_dict: writing the block IS the opt-in
            c.devprof = DevprofConfig.coerce(d["devprof"])
        if "obs_wire" in d:
            # coerce, not from_dict: writing the block IS the opt-in
            c.obs_wire = ObsWireConfig.coerce(d["obs_wire"])
        return c

    @classmethod
    def from_file(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # ------------------------------------------------------ batch arithmetic
    def resolve_batch_sizes(self, dp_world: int) -> None:
        """Solve train = micro * accum * dp_world (ref: config.py

        ``_configure_train_batch_size``): any two given determine the third;
        one given assumes the others default; all three must be consistent.
        """
        if self.elasticity is not None and self.elasticity.enabled:
            # elastic mode owns the batch config: explicit batch keys
            # beside it are a config error (ref: elasticity.py
            # ensure_immutable_elastic_config).  Values a previous elastic
            # resolution wrote do not count as explicit, so a second
            # engine on the same Config re-resolves for its world size
            if getattr(self, "_batch_from_elastic", False):
                self.train_batch_size = None
                self.train_micro_batch_size_per_gpu = None
                self.gradient_accumulation_steps = None
            fixed = [k for k, v in (
                (TRAIN_BATCH_SIZE, self.train_batch_size),
                (MICRO_BATCH, self.train_micro_batch_size_per_gpu),
                (GRAD_ACCUM, self.gradient_accumulation_steps))
                if v is not None]
            if fixed:
                raise ValueError(
                    f"elasticity is enabled but {fixed} set explicitly; "
                    "elastic mode computes the batch config itself")
            from deepspeed_tpu_torch.elasticity import compute_elastic_config

            run = compute_elastic_config(self.elasticity, world_size=dp_world)
            self.train_batch_size = run["train_batch_size"]
            self.train_micro_batch_size_per_gpu = \
                run["train_micro_batch_size_per_gpu"]
            self.gradient_accumulation_steps = \
                run["gradient_accumulation_steps"]
            self._batch_from_elastic = True
            return
        if dp_world < 1:
            raise ValueError(f"dp_world must be positive, got {dp_world}")
        t, m, a = (self.train_batch_size, self.train_micro_batch_size_per_gpu,
                   self.gradient_accumulation_steps)
        # validate RAW inputs before the arithmetic: a zero would either
        # ZeroDivisionError in the divisibility checks below (two values
        # given) or solve into empty-batch training / accum-0-acting-as-1
        # (one value given)
        for name, val in ((TRAIN_BATCH_SIZE, t), (MICRO_BATCH, m),
                          (GRAD_ACCUM, a)):
            if val is not None and val < 1:
                raise ValueError(
                    f"batch config must be positive: {name}={val}")
        if t is not None and m is not None and a is not None:
            if t != m * a * dp_world:
                raise ValueError(
                    f"batch sizes inconsistent: {t} != {m}*{a}*{dp_world}")
        elif t is not None and m is not None:
            if t % (m * dp_world) != 0:
                raise ValueError(
                    f"train_batch_size {t} not divisible by micro*dp {m * dp_world}")
            a = t // (m * dp_world)
        elif t is not None and a is not None:
            if t % (a * dp_world) != 0:
                raise ValueError(
                    f"train_batch_size {t} not divisible by accum*dp {a * dp_world}")
            m = t // (a * dp_world)
        elif m is not None:
            a = a or 1
            t = m * a * dp_world
        elif a is not None:
            m = 1
            t = m * a * dp_world
        elif t is not None:
            a = 1
            if t % dp_world != 0:
                raise ValueError(
                    f"train_batch_size {t} not divisible by dp world {dp_world}")
            m = t // dp_world
        else:
            m, a = 1, 1
            t = dp_world
        self.train_batch_size = t
        self.train_micro_batch_size_per_gpu = m
        self.gradient_accumulation_steps = a
