"""Sequence packing for LM pretraining batches.

Copy of ``horovod_tpu/data/packing.py`` (``pack_documents``,
``pack_batches``, ``packing_efficiency``): pure numpy, kept here so that
the port imports nothing of the JAX package.  Several documents share one fixed-length
row; ``segment_ids`` mark document membership (ids start at 1; 0 is
padding).
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Sequence, Tuple

import numpy as np


def pack_documents(
    docs: Sequence[np.ndarray],
    seq_len: int,
    pad_id: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy first-fit packing of token arrays into ``(rows, seq_len)``.

    Returns ``(tokens, segment_ids)`` int32 arrays of identical shape.
    Documents longer than ``seq_len`` are split into ``seq_len`` chunks
    (standard LM practice — each chunk becomes its own segment).
    Segment ids are unique per (row, document) starting at 1; padding
    positions carry segment id 0 and ``pad_id`` tokens.  No documents
    (or only zero-length ones) yield empty ``(0, seq_len)`` arrays —
    never a phantom all-padding row, which would dilute loss masks and
    batch statistics downstream.
    """
    if seq_len <= 0:
        raise ValueError(f"seq_len must be positive, got {seq_len}")
    pieces: List[np.ndarray] = []
    for d in docs:
        d = np.asarray(d).reshape(-1)
        for lo in range(0, len(d), seq_len):
            piece = d[lo:lo + seq_len]
            if len(piece):
                pieces.append(piece)
    # First-fit decreasing: sort longest-first for tighter rows.
    order = sorted(range(len(pieces)), key=lambda i: -len(pieces[i]))
    rows: List[List[np.ndarray]] = []
    space: List[int] = []
    for i in order:
        piece = pieces[i]
        for r in range(len(rows)):
            if space[r] >= len(piece):
                rows[r].append(piece)
                space[r] -= len(piece)
                break
        else:
            rows.append([piece])
            space.append(seq_len - len(piece))
    n = len(rows)
    tokens = np.full((n, seq_len), pad_id, np.int32)
    segs = np.zeros((n, seq_len), np.int32)
    for r, row in enumerate(rows):
        off = 0
        for s, piece in enumerate(row, start=1):
            tokens[r, off:off + len(piece)] = piece
            segs[r, off:off + len(piece)] = s
            off += len(piece)
    return tokens, segs


def pack_batches(
    docs: Iterable[np.ndarray],
    seq_len: int,
    batch_size: int,
    pad_id: int = 0,
    drop_remainder: bool = True,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield ``(tokens, segment_ids)`` batches of shape
    ``(batch_size, seq_len)`` from a document stream (static shapes).
    Rows pack greedily within a window of documents."""
    window: List[np.ndarray] = []
    # Pack in windows big enough to fill ~2 batches so first-fit has
    # material to work with, then emit full batches.
    rows_t: List[np.ndarray] = []
    rows_s: List[np.ndarray] = []
    for d in docs:
        window.append(np.asarray(d).reshape(-1))
        if sum(len(w) for w in window) >= 2 * batch_size * seq_len:
            t, s = pack_documents(window, seq_len, pad_id)
            rows_t.extend(t)
            rows_s.extend(s)
            window = []
        while len(rows_t) >= batch_size:
            yield (np.stack(rows_t[:batch_size]),
                   np.stack(rows_s[:batch_size]))
            rows_t, rows_s = rows_t[batch_size:], rows_s[batch_size:]
    if window:
        t, s = pack_documents(window, seq_len, pad_id)
        rows_t.extend(t)
        rows_s.extend(s)
    while len(rows_t) >= batch_size:
        yield (np.stack(rows_t[:batch_size]), np.stack(rows_s[:batch_size]))
        rows_t, rows_s = rows_t[batch_size:], rows_s[batch_size:]
    if rows_t and not drop_remainder:
        pad_rows = batch_size - len(rows_t)
        t = np.concatenate(
            [np.stack(rows_t),
             np.full((pad_rows, seq_len), pad_id, np.int32)]
        )
        s = np.concatenate(
            [np.stack(rows_s), np.zeros((pad_rows, seq_len), np.int32)]
        )
        yield t, s


def packing_efficiency(segment_ids: np.ndarray) -> float:
    """Fraction of non-padding positions (1.0 = zero waste)."""
    segs = np.asarray(segment_ids)
    return float((segs > 0).mean()) if segs.size else 0.0
