"""Hand-written Hopper kernels (``csrc/``), their ctypes wrappers, their
plain PyTorch versions (``ref``) and the dispatch by device (``ops``):

* ``segment_hist`` — the LIST-SCAN accumulator (replaces the reference
  package's Pallas ``kernels/segment_cooc.py``);
* ``topk_gather`` — the serving score-and-select step (replaces its Pallas
  ``kernels/topk_gather.py``).

Kernels build with ``nvcc`` at first launch (``_build``), never at import.
"""
