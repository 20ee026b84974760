"""Document sources for the continuous-ingest streaming subsystem.

A source is anything the :class:`~repro_torch.stream.daemon.StreamIngestor` can
tail: it hands out *complete* documents in arrival order, each paired with
the **offset** the stream cursor must record so a restarted daemon resumes
exactly after it. Two implementations cover the production and test
topologies:

* :class:`FileTailSource` — tails an append-only feed file (one document
  per line, whitespace-separated integer term IDs). Offsets are byte
  offsets, so they stay valid across process restarts; a partially written
  last line is never consumed (the tailer only advances past a ``\\n``),
  which makes concurrent ``write_feed`` appends safe without any locking.
* :class:`QueueSource` — an in-process deque for unit tests and embedded
  producers. Offsets are document ordinals; ``close()`` marks the end of
  the stream so a draining ingestor can tell "idle" from "done".

Both yield raw term-ID arrays; per-document preprocessing (dedup + sort,
the ``Collection`` invariant) happens in the ingestor so every source stays
a dumb byte/array mover.
"""

from __future__ import annotations

import collections
import os

import numpy as np


def write_feed(path: str, docs, *, append: bool = True) -> int:
    """Append documents (iterable of term-ID sequences) to a feed file in
    the one-line-per-document format :class:`FileTailSource` tails. Returns
    the file's end offset after the write. Each line is written atomically
    enough for a tailer (a single buffered write, flushed), and a document
    with no terms becomes an empty line — still a document."""
    mode = "a" if append else "w"
    with open(path, mode, encoding="ascii") as f:
        for terms in docs:
            f.write(" ".join(str(int(t)) for t in np.asarray(terms).ravel()))
            f.write("\n")
        f.flush()
        os.fsync(f.fileno())
        return f.tell()


def collection_to_feed(path: str, c, *, append: bool = False) -> int:
    """Write a whole :class:`~repro_torch.data.corpus.Collection` as a feed file
    (document order preserved). The batch-vs-stream identity checks build
    their feeds with this."""
    return write_feed(
        path, (c.doc(d) for d in range(c.num_docs)), append=append
    )


class QueueSource:
    """In-process document source (tests, embedded producers).

    ``push`` enqueues one document; ``poll`` drains what has arrived.
    Offsets are running document ordinals — durable resume across processes
    is :class:`FileTailSource`'s job, but ``seek`` still replays the
    contract (it may only land on the current head, which catches a cursor
    that drifted from the source).
    """

    def __init__(self):
        self._docs: collections.deque = collections.deque()
        self._popped = 0  # ordinal of the next document to hand out
        self._closed = False

    def push(self, terms) -> None:
        if self._closed:
            raise RuntimeError("push() on a closed QueueSource")
        self._docs.append(np.asarray(terms))

    def push_collection(self, c) -> None:
        """Enqueue every document of a Collection, in document order."""
        for d in range(c.num_docs):
            self.push(c.doc(d))

    def close(self) -> None:
        """Mark the end of the stream: ``exhausted`` turns True once every
        pushed document has been polled."""
        self._closed = True

    @property
    def exhausted(self) -> bool:
        return self._closed and not self._docs

    def seek(self, offset: int) -> None:
        if offset != self._popped:
            raise ValueError(
                f"QueueSource cannot seek to {offset} (head is at "
                f"{self._popped}); in-memory sources do not survive restarts"
            )

    def poll(self, max_docs: int | None = None) -> list[tuple[int, np.ndarray]]:
        """Drain up to ``max_docs`` queued documents as
        ``(offset_after_doc, terms)`` pairs (possibly empty, never blocks)."""
        out = []
        while self._docs and (max_docs is None or len(out) < max_docs):
            terms = self._docs.popleft()
            self._popped += 1
            out.append((self._popped, terms))
        return out


class FileTailSource:
    """Tail an append-only feed file of one-line documents.

    Offsets are byte offsets into the file; ``poll`` parses every complete
    line between the current offset and EOF (bounded by
    ``max_bytes_per_poll`` per call) and leaves a trailing partial line —
    bytes after the last ``\\n`` — for the next poll, so a producer mid-
    ``write`` is never observed torn. A single document longer than
    ``max_bytes_per_poll`` grows the read window for that poll rather than
    stalling forever with no progress. A missing file is "no documents
    yet", not an error: the daemon may start before its producer.
    """

    def __init__(self, path: str, *, start_offset: int = 0,
                 max_bytes_per_poll: int = 4 << 20):
        self.path = path
        self._offset = int(start_offset)
        self.max_bytes_per_poll = int(max_bytes_per_poll)

    @property
    def offset(self) -> int:
        return self._offset

    @property
    def exhausted(self) -> bool:
        # a file feed has no in-band end marker; "done" is the ingestor's
        # idle timeout / max_docs call, not the source's
        return False

    def seek(self, offset: int) -> None:
        self._offset = int(offset)

    def poll(self, max_docs: int | None = None) -> list[tuple[int, np.ndarray]]:
        """Complete documents appended since the last poll, as
        ``(byte_offset_after_line, terms)``. Never blocks."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []
        if size <= self._offset:
            return []
        out = []
        with open(self.path, "rb") as f:
            f.seek(self._offset)
            read_size = self.max_bytes_per_poll
            chunk = f.read(read_size)
            # one document longer than the window must not stall the
            # tailer forever: a full chunk with no newline means the line
            # continues past it, so grow the window until the line's end
            # (or EOF — then it is a genuine partial still being written)
            while b"\n" not in chunk and len(chunk) == read_size:
                read_size *= 2
                f.seek(self._offset)
                chunk = f.read(read_size)
        consumed = 0
        while True:
            if max_docs is not None and len(out) >= max_docs:
                break
            nl = chunk.find(b"\n", consumed)
            if nl < 0:
                break  # trailing partial line: leave it for the next poll
            line = chunk[consumed:nl]
            consumed = nl + 1
            terms = (
                np.fromiter((int(t) for t in line.split()), dtype=np.int64)
                if line.strip() else np.zeros(0, dtype=np.int64)
            )
            out.append((self._offset + consumed, terms))
        self._offset += consumed
        return out
