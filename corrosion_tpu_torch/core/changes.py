"""Changeset chunking.

Mirrors corro-types/src/change.rs (`ChunkedChanges` :8-114): stream rows of a
(possibly huge) transaction into chunks of at most ``max_bytes`` estimated
wire bytes, each tagged with the inclusive seq range it covers, so a single
10k-row transaction can be broadcast/synced incrementally and reassembled with
gap tracking on the receiving side.
"""

from __future__ import annotations

from typing import Iterable, Iterator

from .values import Change

MAX_CHANGES_BYTE_SIZE = 8 * 1024  # change.rs:116


def chunk_changes(
    rows: Iterable[Change],
    last_seq: int,
    max_bytes: int = MAX_CHANGES_BYTE_SIZE,
) -> Iterator[tuple[list[Change], tuple[int, int]]]:
    """Yield (changes, (seq_start, seq_end)) chunks.

    Seq ranges tile [0, last_seq] contiguously even when rows skip seqs, and
    the final chunk always extends to ``last_seq`` — matching ChunkedChanges:
    the receiver tracks which seq ranges it holds, so emitted ranges must
    cover the whole transaction without holes.
    """
    chunk: list[Change] = []
    chunk_start = 0
    size = 0
    for row in rows:
        chunk.append(row)
        size += row.estimated_byte_size()
        if size >= max_bytes:
            yield chunk, (chunk_start, row.seq)
            chunk_start = row.seq + 1
            chunk = []
            size = 0
    if chunk or chunk_start <= last_seq:
        yield chunk, (chunk_start, last_seq)


def max_seq(rows: list[Change], default: int = 0) -> int:
    return max((r.seq for r in rows), default=default)


class AdaptiveChunker:
    """Adaptive sync chunk sizing (peer.rs:352-355, 638-653): the server
    halves its chunk byte target whenever a send takes longer than the
    threshold (500 ms in the reference), floored at 1 KiB — a slow or
    congested peer gets smaller messages instead of head-of-line blocking.
    """

    def __init__(
        self,
        max_bytes: int = MAX_CHANGES_BYTE_SIZE,
        min_bytes: int = 1024,
        threshold_s: float = 0.5,
    ) -> None:
        self.max_bytes = max_bytes
        self.min_bytes = min_bytes
        self.threshold_s = threshold_s
        self.halvings = 0

    def record(self, send_seconds: float) -> bool:
        """Feed one send duration. Returns True when the chunk target
        actually halved (already-at-floor slow sends don't count — the
        defense has no smaller step left to take), so the caller can
        surface halvings as a counter."""
        if send_seconds > self.threshold_s:
            new = max(self.min_bytes, self.max_bytes // 2)
            if new < self.max_bytes:
                self.max_bytes = new
                self.halvings += 1
                return True
        return False
