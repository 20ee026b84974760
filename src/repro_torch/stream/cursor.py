"""Durable stream cursor: exactly-once resume for the micro-segment tailer.

The cursor answers one question after a crash: *which prefix of the source
has already been committed as segments?* It is stored **inside the store
manifest** itself, under a top-level ``"stream"`` key::

    "stream": {"<source_id>": {"offset": 18734, "docs": 412, "seals": 7}}

and is only ever advanced through
:meth:`~repro_torch.store.segments.Store.add_segment_from_rows`'s
``extra_mutate`` hook — i.e. inside the *same* flock'd, generation-
countered manifest commit that makes the sealed segment visible. Segment
append and cursor advance are therefore one atomic step: a SIGKILL either
lands before the commit (the pending segment directory is unreferenced
garbage, the cursor still points at the old offset, and the restarted
daemon re-reads and re-counts those documents) or after it (the segment is
live and the cursor has already moved past its documents). No document can
be double-committed or dropped — the same commit-under-lock discipline
:class:`repro_torch.runtime.fault.SharedWorkTracker` uses for shard leases,
applied to the manifest the readers already watch.

Because ``Store._commit`` is a read-modify-write that preserves unrelated
manifest keys, the cursor survives compaction, transcoding and concurrent
batch appends untouched.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CursorState:
    """Committed position of one stream source.

    ``offset`` is source-defined (byte offset for a file feed, document
    ordinal for a queue), ``docs`` counts documents committed so far and
    ``seals`` counts micro-segment commits — both feed freshness stats and
    the fencing check below.
    """

    offset: int = 0
    docs: int = 0
    seals: int = 0

    def as_dict(self) -> dict:
        return {"offset": int(self.offset), "docs": int(self.docs),
                "seals": int(self.seals)}


class StreamCursor:
    """Reader/mutator for one source's cursor in a store manifest."""

    def __init__(self, store, source_id: str):
        self.store = store
        self.source_id = str(source_id)

    def load(self) -> CursorState:
        """Committed state as of the latest manifest generation."""
        self.store.refresh()
        raw = self.store.manifest.get("stream", {}).get(self.source_id)
        if raw is None:
            return CursorState()
        return CursorState(offset=int(raw["offset"]), docs=int(raw["docs"]),
                           seals=int(raw.get("seals", 0)))

    def advance_mutation(self, prev: CursorState, new_offset: int,
                         docs_added: int):
        """Manifest mutation advancing ``prev`` → ``new_offset``.

        Pass the returned callable as ``extra_mutate`` to
        ``add_segment_from_rows(..., single_commit=True)``. It runs under
        the manifest lock and **fences**: if the on-disk cursor no longer
        matches ``prev`` (a second daemon committed for this source in the
        meantime), it raises and thereby aborts the whole commit before the
        segment becomes visible — the losing daemon's pending directory is
        left unreferenced, exactly as if it had crashed pre-commit.
        """
        source_id = self.source_id

        def mutate(m: dict) -> None:
            stream = m.setdefault("stream", {})
            on_disk = stream.get(source_id)
            disk_offset = int(on_disk["offset"]) if on_disk else 0
            disk_docs = int(on_disk["docs"]) if on_disk else 0
            disk_seals = int(on_disk.get("seals", 0)) if on_disk else 0
            if disk_offset != prev.offset:
                raise StreamCursorConflict(
                    f"stream cursor for {source_id!r} moved under us: "
                    f"expected offset {prev.offset}, manifest has "
                    f"{disk_offset} (another daemon is tailing this source?)"
                )
            stream[source_id] = CursorState(
                offset=int(new_offset),
                docs=disk_docs + int(docs_added),
                seals=disk_seals + 1,
            ).as_dict()

        return mutate


class StreamCursorConflict(RuntimeError):
    """Another writer advanced this source's cursor between our read and
    our commit; the seal was aborted and no segment was published."""
