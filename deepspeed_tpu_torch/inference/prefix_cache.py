"""Content-addressing for paged-KV prefix caching (port of
``deepspeed_tpu/inference/prefix_cache.py``, kept whole: the keys are
byte-equal to the JAX package's; ref: vLLM automatic prefix caching /
SGLang RadixAttention — block-hash prefix reuse over a paged KV pool).

A full KV page holds the K/V of one ``page_size``-token span.  Under
causal attention, that span's K/V depends ONLY on the tokens at and
before it — so a page written for tokens ``t[0:ps]`` of one request is
bit-identical to the page any other request with the same leading
tokens would write, and can be mapped read-only into that request's
page table instead of being recomputed.

Keys are CHAINED hashes: page ``k``'s key digests page ``k-1``'s key
plus page ``k``'s own token span.  The chain makes the flat
``{key: page}`` index behave as a radix trie over page-aligned token
prefixes — walking a prompt's keys in order and stopping at the first
miss yields exactly the longest cached page-aligned prefix, and two
prompts sharing a span mid-sequence but not the tokens before it can
never alias (their chains diverged earlier).

blake2b/16-byte digests: collisions are negligible (~2^-64 at any
realistic pool size), and a collision would require an adversarially
constructed token sequence, not traffic.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional, Sequence, Tuple

_SEED = b"dstpu-prefix-cache-v1"


@dataclasses.dataclass
class TierEntry:
    """Index record of ONE demoted page: which tier holds its KV and in
    what encoding.  The HBM index (``PageAllocator.index``) maps key →
    physical page; everything evicted OUT of HBM keeps matching through
    these records in the :class:`~deepspeed_tpu_torch.inference.kv_tier.
    KVTierPool` — the chained-key walk treats an entry in ANY tier as a
    hit, it just re-admits through promotion instead of a refcount bump.

    ``buffers`` is the per-buffer geometry of the spilled payload —
    ``(name, shape, dtype)`` triples; 2 buffers (k, v) on the bit-exact
    path, 4 (k codes, k scales, v codes, v scales) when the page was
    quantized cold.  ``data`` holds the host arrays while the entry is
    host-resident; an NVMe-resident entry's payload lives in the files
    named by ``buffers`` and ``data`` is None."""

    key: bytes
    location: str                 # "host" | "nvme"
    quantized: bool
    dtype: str                    # the PAGE dtype promotion restores
    buffers: Tuple[Tuple[str, tuple, str], ...]
    nbytes: int
    data: Optional[tuple] = None  # host arrays iff location == "host"
    tick: int = 0                 # age for the host->nvme->drop cascade
    # per-buffer crc32 recorded at demote time and verified on promote:
    # a mismatch (bit rot, torn spill write, injected corruption) drops
    # the entry and the consumer re-prefills instead of serving garbage
    checksums: Optional[Tuple[int, ...]] = None

    @property
    def names(self) -> List[str]:
        return [b[0] for b in self.buffers]


def key_hex(key: bytes) -> str:
    """Canonical short form of a page key for file names / trace
    attrs."""
    return key.hex()


def page_key(prev_key: bytes, span: Sequence[int]) -> bytes:
    """Key of one full page: digest of the previous page's key (the
    prefix chain) + this page's token span."""
    h = hashlib.blake2b(prev_key, digest_size=16)
    h.update(b"".join(int(t).to_bytes(4, "little", signed=True)
                      for t in span))
    return h.digest()


def extend_page_keys(keys: List[bytes], tokens: Sequence[int],
                     n_pages: int, page_size: int) -> List[bytes]:
    """Extend a chained key list IN PLACE to cover the first
    ``n_pages`` full pages of ``tokens``.  The chain only ever grows
    (token prefixes are immutable), so callers cache the list on the
    request and each publish/match event hashes just the new pages
    instead of re-walking the whole sequence."""
    prev = keys[-1] if keys else _SEED
    for k in range(len(keys), n_pages):
        prev = page_key(prev, tokens[k * page_size:(k + 1) * page_size])
        keys.append(prev)
    return keys


def page_keys(tokens: Sequence[int], page_size: int) -> List[bytes]:
    """Chained keys for every FULL page of ``tokens`` (the trailing
    partial page has no key — only immutable full pages are shareable).
    """
    return extend_page_keys([], tokens, len(tokens) // page_size,
                            page_size)


def matchable_pages(prompt_len: int, page_size: int) -> int:
    """How many leading full pages of a ``prompt_len``-token prompt are
    eligible to match: at least ONE prompt token must always go through
    prefill (the engine needs logits at the last prompt position to
    sample the first generated token), so a fully page-aligned prompt
    gives up its final page.  This is the vLLM rule (cap the match at
    ``len(prompt) - 1`` tokens), page-aligned."""
    return max(prompt_len - 1, 0) // page_size
