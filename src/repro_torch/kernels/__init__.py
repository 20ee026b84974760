"""Hand-written Hopper kernels (``csrc/``), their ctypes wrappers, their
plain PyTorch versions (``ref``) and the dispatch by device (``ops``):

* ``segment_hist`` — the LIST-SCAN accumulator (replaces the reference
  package's Pallas ``kernels/segment_cooc.py``);
* ``topk_gather`` — the serving score-and-select step (replaces its Pallas
  ``kernels/topk_gather.py``);
* ``cooc_gram`` — the exact Gram of 0/1 incidence tiles behind LIST-BLOCKS,
  MULTI-SCAN and the FREQ-SPLIT head (replaces its Pallas
  ``kernels/cooc_gram.py``);
* ``bitpair`` — AND + popcount intersection sizes behind LIST-PAIRS
  (replaces its Pallas ``kernels/bitpair.py``).

Kernels build with ``nvcc`` at first launch (``_build``), never at import.
"""
