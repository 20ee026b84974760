"""PyTorch/CUDA port of the co-occurrence counting and serving system.

Beside the JAX reference package ``repro``, and independent of it: this
package imports ``torch`` and numpy, never JAX and nothing of ``repro``.
Stores cross between the two through their shared on-disk format
(docs/formats.md).

The main path: ``Collection`` → ``InvertedIndex``/``DeviceIndex`` →
``Planner``/``PlanExecutor`` running LIST-SCAN (or, on df-descending IDs,
FREQ-SPLIT) → ``SpillSink`` → CSR segment under the store manifest →
``QueryEngine`` top-k by count, PMI or Dice. Hand-written Hopper kernels
carry it on the card (``kernels/csrc``): ``segment_hist`` (the LIST-SCAN
accumulator and the FREQ-SPLIT tail), ``cooc_gram`` (the exact Gram of the
FREQ-SPLIT head, LIST-BLOCKS and MULTI-SCAN), ``bitpair`` (LIST-PAIRS'
AND + popcount) and ``topk_gather`` (the serving score-and-select step).
Entry points run on the card unless the caller passes ``device="cpu"``
(see ``repro_torch.device``).
"""
