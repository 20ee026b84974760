"""Continuous-ingest streaming: micro-segment tailer with bounded
visibility lag.

The batch pipeline builds a store once; this package keeps one *current*:
a :class:`StreamIngestor` tails a document source, seals micro-segments on
a size-or-age trigger so every document is queryable within a configured
lag budget, and records its position in a manifest-resident
:class:`StreamCursor` advanced atomically with each segment commit
(exactly-once across crashes). The companion
:class:`~repro_torch.store.compaction.CompactionDaemon` folds the resulting
micro-segment tail back down so read amplification stays bounded.

Each seal counts on ``StreamConfig.device``: on the card (the default)
with ``list-scan-segment``, so every seal launches the ``segment_hist``
kernel in the ingesting process. The cursor and the feed format are the
reference package's, so a store streamed by either package resumes in the
other. See docs/streaming.md for the lag contract and crash-resume
guarantees.
"""

from repro_torch.stream.cursor import CursorState, StreamCursor, StreamCursorConflict
from repro_torch.stream.daemon import StreamConfig, StreamIngestor
from repro_torch.stream.source import (
    FileTailSource,
    QueueSource,
    collection_to_feed,
    write_feed,
)

__all__ = [
    "CursorState",
    "StreamCursor",
    "StreamCursorConflict",
    "StreamConfig",
    "StreamIngestor",
    "FileTailSource",
    "QueueSource",
    "collection_to_feed",
    "write_feed",
]
