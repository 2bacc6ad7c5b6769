"""Sequence packing for the packed-attention path (port of
``deepspeed_tpu/data/packing.py``; ref: the data efficiency suite's
variable-length batching).  Static [B, T] shapes with segment ids keep
documents isolated in attention and loss; on the card the flash kernels
take the ids (B1–B3's segment instantiations).

Produces batches in the llama ``loss_fn`` contract: ``tokens`` [B, T]
int32 and token-aligned ``segment_ids`` [B, T] int32 where id 0 is
padding and each document gets 1, 2, ... per row.  Downstream,
``models/llama.py`` isolates attention per id and masks cross-document /
padding targets out of the CE (``llama.packed_doc_mask``).  Bit for bit
the JAX package's packing.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np


def pack_documents(docs: Iterable[Sequence[int]], seq_len: int,
                   pad_id: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy first-fit packing → (tokens [B, T], segment_ids [B, T]).

    Deterministic for a given doc order.  Documents longer than
    ``seq_len`` are truncated (the reference's seqlen truncation
    behavior); empty documents are skipped.
    """
    rows: List[List[int]] = []
    segs: List[List[int]] = []
    for doc in docs:
        doc = list(doc[:seq_len])
        if not doc:
            continue
        for r in range(len(rows)):
            if len(rows[r]) + len(doc) <= seq_len:
                segs[r] += [segs[r][-1] + 1] * len(doc)
                rows[r] += doc
                break
        else:
            rows.append(doc)
            segs.append([1] * len(doc))
    B = len(rows)
    tokens = np.full((B, seq_len), pad_id, np.int32)
    segments = np.zeros((B, seq_len), np.int32)
    for r in range(B):
        tokens[r, :len(rows[r])] = rows[r]
        segments[r, :len(segs[r])] = segs[r]
    return tokens, segments


def packing_efficiency(segment_ids: np.ndarray) -> float:
    """Fraction of slots holding real tokens (1.0 = zero padding)."""
    seg = np.asarray(segment_ids)
    return float((seg > 0).mean()) if seg.size else 0.0


class PackedDataLoader:
    """Wraps an iterable of token-id documents into packed train batches
    ``{"tokens", "segment_ids"}`` of static shape [batch_rows, seq_len]
    (+1 column so the loss's next-token shift stays inside the row —
    the llama/Mixtral ``loss_fn`` contract).

    Greedy packing runs over a window of ``batch_rows * fill_factor``
    documents at a time; rows left over when a window can't fill a whole
    batch CARRY OVER into the pending pool and mix with the next
    window's rows (no row is emitted early), and the final short batch
    is padded up to ``batch_rows`` with empty (all-padding) rows so
    every batch has the same static shape.
    """

    def __init__(self, documents: Sequence[Sequence[int]],
                 batch_rows: int, seq_len: int, pad_id: int = 0,
                 fill_factor: int = 4):
        if batch_rows < 1 or seq_len < 2:
            raise ValueError("batch_rows >= 1 and seq_len >= 2 required")
        self.docs = documents
        self.batch_rows = batch_rows
        self.seq_len = seq_len
        self.pad_id = pad_id
        self.window = max(batch_rows * fill_factor, batch_rows)

    def __iter__(self):
        pending_t: List[np.ndarray] = []
        pending_s: List[np.ndarray] = []

        def emit():
            t = np.stack(pending_t[:self.batch_rows])
            s = np.stack(pending_s[:self.batch_rows])
            del pending_t[:self.batch_rows], pending_s[:self.batch_rows]
            return {"tokens": t, "segment_ids": s}

        for w0 in range(0, len(self.docs), self.window):
            toks, segs = pack_documents(
                self.docs[w0:w0 + self.window], self.seq_len + 1,
                self.pad_id)
            pending_t.extend(toks)
            pending_s.extend(segs)
            while len(pending_t) >= self.batch_rows:
                yield emit()
        if pending_t:
            pad_rows = self.batch_rows - len(pending_t)
            pending_t.extend(
                [np.full(self.seq_len + 1, self.pad_id, np.int32)]
                * pad_rows)
            pending_s.extend(
                [np.zeros(self.seq_len + 1, np.int32)] * pad_rows)
            yield emit()
