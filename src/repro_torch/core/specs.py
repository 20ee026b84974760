"""Typed method specifications: the counting registry, made first-class.

Each counting method is described by a frozen :class:`MethodSpec` — its
callable, its typed/validated tuning parameters, and a **cost model** derived
from the paper's §3 asymptotics, expressed over :class:`CollectionStats`
(documents, postings, df distribution, vocabulary). The specs replace the
raw ``METHODS`` dict: drivers and benchmarks stop re-hardcoding per-method
kwargs tables, and the planner (core/plan.py) turns ``method="auto"`` into a
measured decision instead of a caller-supplied string.

Cost-model units: one vectorized numpy element operation ≈ 1 unit; a
Python-level call (loop iteration, numpy dispatch) is charged a constant
number of units. The absolute scale is arbitrary — only the *ranking* across
methods matters — but the terms mirror the paper's analysis:

* NAÏVE          O(Σ len²) dictionary operations (large constant);
* LIST-PAIRS     O(v²) intersections, each reading both posting lists;
* LIST-BLOCKS    b ≈ √V blocks → O(P·√V) postings work, no merge phase;
* LIST-SCAN      O(Σ len²) element work + per-posting traversal + a
                 V-wide accumulator per live row;
* MULTI-SCAN     ⌈V/a⌉ passes over the (shrinking) forward file;
* FREQ-SPLIT     dense head Gram (matmul-cheap) + tail postings work.

The constants are the reference package's, calibrated against its CPU
implementations; the port keeps them so that ``method="auto"`` on the host
picks what the reference picks.

Kinds say where a method runs and whether ``method="auto"`` ranks it
(``core/plan.Planner.candidates``):

* ``paper``  — the five host methods of the paper; ranked on the CPU;
* ``gpu``    — ``list-scan-segment``, LIST-SCAN on the ``segment_hist``
  kernel; ranked on a CUDA device;
* ``hybrid`` — ``freq-split``, on the ``cooc_gram`` and ``segment_hist``
  kernels; ranked on either device when term IDs are df-descending;
* ``opt-in`` — the kernel adaptations of the other paper traversals
  (``list-blocks-gram`` and ``multi-scan-matmul`` on ``cooc_gram``,
  ``list-pairs-bitpacked`` on ``bitpair``); never ranked, run only when
  named. Their cost models are their parent traversal's, which price host
  loops: ranked on the card, ``multi-scan-matmul`` would beat
  ``list-scan-segment`` on WT10G-shaped data while building a dense
  (2048, V) host tile on each of V/128 passes.

Every kind but ``paper`` takes a ``device`` parameter: the kernels on
``"cuda"``, their plain PyTorch versions on ``"cpu"``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping

from repro_torch.data.corpus import Collection, CollectionStats

# ---------------------------------------------------------------------------
# typed tuning parameters
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Param:
    """One typed tuning knob of a counting method."""

    name: str
    type: type
    default: object
    minimum: int | None = None
    allow_none: bool = False
    doc: str = ""

    def validate(self, value):
        """Coerce-free validation; raises TypeError/ValueError."""
        if value is None:
            if not self.allow_none:
                raise TypeError(f"param {self.name!r} must not be None")
            return value
        # bool is an int subclass; keep the two distinct for clarity
        if self.type is int and isinstance(value, bool):
            raise TypeError(f"param {self.name!r} expects int, got bool")
        if not isinstance(value, self.type):
            raise TypeError(
                f"param {self.name!r} expects {self.type.__name__}, "
                f"got {type(value).__name__} ({value!r})"
            )
        if self.minimum is not None and value < self.minimum:
            raise ValueError(
                f"param {self.name!r} must be >= {self.minimum}, got {value}"
            )
        return value


# ---------------------------------------------------------------------------
# cost-model constants (the reference package's, calibrated against its CPU
# implementations; see tests/test_plan.py golden selections)
# ---------------------------------------------------------------------------

ELEM = 1.0          # one vectorized element op
CALL = 8.0          # cheap numpy dispatch / intersection call overhead
PY_LOOP = 48.0      # Python-level per-iteration overhead (doc fetch, slicing)
DICT_OP = 16.0      # per-pair dictionary get/set (NAÏVE's large constant)
MATMUL_ELEM = 0.002  # per-flop cost of a BLAS/MXU Gram matmul


def cost_naive(s: CollectionStats, kw: Mapping) -> float:
    # every pair occurrence is a dictionary operation; flushing adds sorts
    return DICT_OP * 2.0 * s.pair_occurrences + PY_LOOP * s.num_docs


def cost_list_pairs(s: CollectionStats, kw: Mapping) -> float:
    # v²/2 intersections; each reads both posting lists → Σ_{i<j}(df_i+df_j)
    # = (v-1)·P elements
    v = s.live_vocab
    return 0.5 * v * v * CALL + ELEM * max(v - 1, 0) * s.num_postings


def cost_list_blocks(s: CollectionStats, kw: Mapping) -> float:
    V = s.vocab_size
    k = kw.get("block_size") or max(1, math.isqrt(V))
    b = (V + k - 1) // k
    return (
        PY_LOOP / 6.0 * s.num_docs * b          # block build: doc scan per block
        + 2.0 * CALL * b * b                    # block-pair loop overhead
        + 1.5 * ELEM * s.num_postings * b       # postings touched per block pair
        + 4.0 * ELEM * 2.0 * s.pair_occurrences  # np.add.at increments
    )


def cost_list_scan(s: CollectionStats, kw: Mapping) -> float:
    return (
        2.0 * CALL * s.live_vocab               # per-row bookkeeping
        + 2.0 * PY_LOOP * s.num_postings        # per-(term, doc) inner loop
        + 2.0 * ELEM * 2.0 * s.pair_occurrences  # histogram increments
        + 0.5 * ELEM * s.live_vocab * s.vocab_size  # row clear + nonzero scan
    )


def cost_multi_scan(s: CollectionStats, kw: Mapping) -> float:
    a = kw.get("accumulators", 100)
    passes = max(1, (s.vocab_size + a - 1) // a)
    # the skip ("fully processed documents") halves the effective doc scans
    docs_scanned = 0.5 * s.num_docs * passes if passes > 1 else s.num_docs
    return (
        1.5 * PY_LOOP * docs_scanned            # per-doc window probe
        + 1.5 * PY_LOOP * s.num_postings        # per primary occurrence
        + 2.0 * ELEM * 2.0 * s.pair_occurrences
        + 0.25 * ELEM * s.vocab_size * s.vocab_size  # a×V accumulator sweeps
    )


def cost_freq_split(s: CollectionStats, kw: Mapping) -> float:
    H = min(kw.get("head", 1024), s.vocab_size)
    head_postings = s.postings_in_top(H)
    tail_postings = s.num_postings - head_postings
    return (
        MATMUL_ELEM * s.num_docs * H * H        # dense head Gram (MXU/BLAS)
        + 0.5 * ELEM * s.num_docs * H           # incidence tile build
        + 2.0 * PY_LOOP * tail_postings         # tail LIST-SCAN inner loop
        + 2.0 * ELEM * 2.0 * s.pair_occurrences
        + 0.25 * ELEM * (s.vocab_size - H) * s.vocab_size  # tail col sweeps
    )


# working-set estimates (bytes) -------------------------------------------------


def mem_naive(s: CollectionStats, kw: Mapping) -> float:
    flush = kw.get("flush_pairs", 2_000_000)
    return 100.0 * min(flush, 2.0 * s.pair_occurrences + 1)


def mem_list_pairs(s: CollectionStats, kw: Mapping) -> float:
    return 8.0 * (s.num_postings + s.live_vocab)  # inverted index


def mem_list_blocks(s: CollectionStats, kw: Mapping) -> float:
    V = s.vocab_size
    k = kw.get("block_size") or max(1, math.isqrt(V))
    return 8.0 * k * V + 8.0 * s.num_postings  # outer accumulator + blocks


def mem_list_scan(s: CollectionStats, kw: Mapping) -> float:
    return 8.0 * s.vocab_size + 8.0 * s.num_postings  # row acc + index


def mem_multi_scan(s: CollectionStats, kw: Mapping) -> float:
    a = kw.get("accumulators", 100)
    return 8.0 * a * s.vocab_size


def mem_freq_split(s: CollectionStats, kw: Mapping) -> float:
    H = min(kw.get("head", 1024), s.vocab_size)
    return 8.0 * H * H + 8.0 * (s.num_postings + s.vocab_size)


# ---------------------------------------------------------------------------
# MethodSpec + registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    """Everything the planner, drivers, and benchmarks need to know about one
    counting method — replacing the stringly-typed ``METHODS`` dict entry and
    the per-driver kwargs tables."""

    name: str
    fn: Callable
    kind: str  # "paper" | "gpu" | "hybrid" | "opt-in" (see the module doc)
    params: tuple[Param, ...] = ()
    cost: Callable[[CollectionStats, Mapping], float] = cost_list_scan
    memory_bytes: Callable[[CollectionStats, Mapping], float] = mem_list_scan
    needs_df_descending: bool = False
    needs_emit_col: bool = False
    doc: str = ""

    # -------------------------------------------------------------- params
    def param(self, name: str) -> Param:
        for p in self.params:
            if p.name == name:
                return p
        raise KeyError(f"method {self.name!r} has no param {name!r}")

    def defaults(self) -> dict:
        return {p.name: p.default for p in self.params}

    def validate_kwargs(self, kwargs: Mapping) -> dict:
        """Validate a *partial* kwargs mapping (unknown keys rejected)."""
        known = {p.name: p for p in self.params}
        out = {}
        for k, v in kwargs.items():
            if k not in known:
                raise TypeError(
                    f"method {self.name!r} got unknown param {k!r}; "
                    f"valid: {sorted(known) or 'none'}"
                )
            out[k] = known[k].validate(v)
        return out

    def resolve_kwargs(self, overrides: Mapping | None = None) -> dict:
        """Defaults merged with validated ``overrides`` — the full kwargs the
        method callable will be invoked with."""
        out = self.defaults()
        if overrides:
            out.update(self.validate_kwargs(overrides))
        return out

    # ---------------------------------------------------------------- run
    def run(self, c: Collection, sink, **kwargs) -> dict:
        """Invoke the method (kwargs validated first)."""
        return self.fn(c, sink, **self.validate_kwargs(kwargs))


_P = Param  # local shorthand for the table below

REGISTRY: dict[str, MethodSpec] = {}


def register(spec: MethodSpec) -> MethodSpec:
    if spec.name in REGISTRY:
        raise ValueError(f"method {spec.name!r} already registered")
    REGISTRY[spec.name] = spec
    return spec


def get_spec(name: str) -> MethodSpec:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown method {name!r}; have {sorted(REGISTRY)}"
        ) from None


def method_names(kind: str | None = None) -> list[str]:
    return [n for n, s in REGISTRY.items() if kind is None or s.kind == kind]


def _build_registry() -> None:
    # deferred imports: the method modules import only data/ + types
    from repro_torch.core.hybrid import count_freq_split
    from repro_torch.core.list_blocks import count_list_blocks, count_list_blocks_gram
    from repro_torch.core.list_pairs import count_list_pairs, count_list_pairs_bitpacked
    from repro_torch.core.list_scan import count_list_scan, count_list_scan_segment
    from repro_torch.core.multi_scan import count_multi_scan, count_multi_scan_matmul
    from repro_torch.core.naive import count_naive

    device = _P("device", str, "cuda",
                doc="'cuda': the hand-written kernels; 'cpu': their plain "
                    "PyTorch versions")

    register(MethodSpec(
        "naive", count_naive, "paper",
        params=(_P("flush_pairs", int, 2_000_000, minimum=1,
                   doc="flush the pair dictionary past this many entries"),),
        cost=cost_naive, memory_bytes=mem_naive,
        doc="document-order dictionary accumulation with flushing (§2)",
    ))
    register(MethodSpec(
        "list-pairs", count_list_pairs, "paper",
        cost=cost_list_pairs, memory_bytes=mem_list_pairs,
        doc="pair-order posting-list intersection (§2); quadratic in vocab",
    ))
    register(MethodSpec(
        "list-blocks", count_list_blocks, "paper",
        params=(_P("block_size", int, None, minimum=1, allow_none=True,
                   doc="lists per block; default ≈ √V (paper's choice)"),),
        cost=cost_list_blocks, memory_bytes=mem_list_blocks,
        doc="block-pair-order traversal, b ≈ √V blocks (§2)",
    ))
    register(MethodSpec(
        "list-scan", count_list_scan, "paper",
        params=(_P("rows_per_batch", int, 64, minimum=1,
                   doc="primaries per batched bincount histogram"),),
        cost=cost_list_scan, memory_bytes=mem_list_scan,
        doc="term-order inverted+forward traversal (§2); best asymptotics, "
            "batched-histogram hot loop",
    ))
    register(MethodSpec(
        "multi-scan", count_multi_scan, "paper",
        params=(_P("accumulators", int, 100, minimum=1,
                   doc="primary keys claimed per forward pass (paper: 100)"),),
        cost=cost_multi_scan, memory_bytes=mem_multi_scan,
        doc="repeated forward scans, a primaries per pass (§2)",
    ))
    # the kernel adaptations follow their parent traversal's asymptotics and
    # are priced with the parent's model
    register(MethodSpec(
        "list-pairs-bitpacked", count_list_pairs_bitpacked, "opt-in",
        params=(_P("block", int, 256, minimum=1), device),
        cost=cost_list_pairs, memory_bytes=mem_list_pairs,
        doc="LIST-PAIRS via blocked AND+popcount bitmaps (bitpair kernel)",
    ))
    register(MethodSpec(
        "list-blocks-gram", count_list_blocks_gram, "opt-in",
        params=(_P("vocab_tile", int, 512, minimum=1),
                _P("doc_tile", int, 2048, minimum=1), device),
        cost=cost_list_blocks, memory_bytes=mem_list_blocks,
        doc="LIST-BLOCKS as tiled Gram on 0/1 incidence (cooc_gram kernel)",
    ))
    register(MethodSpec(
        "list-scan-segment", count_list_scan_segment, "gpu",
        params=(_P("rows_per_batch", int, 64, minimum=1), device),
        cost=cost_list_scan, memory_bytes=mem_list_scan,
        doc="LIST-SCAN as batched segment histograms (segment_hist kernel)",
    ))
    register(MethodSpec(
        "multi-scan-matmul", count_multi_scan_matmul, "opt-in",
        params=(_P("accumulators", int, 128, minimum=1),
                _P("doc_tile", int, 2048, minimum=1), device),
        cost=cost_multi_scan, memory_bytes=mem_multi_scan,
        doc="MULTI-SCAN as skinny Gram products per pass (cooc_gram kernel)",
    ))
    register(MethodSpec(
        "freq-split", count_freq_split, "hybrid",
        params=(_P("head", int, 1024, minimum=0,
                   doc="dense-head vocabulary rank split point"),
                _P("doc_tile", int, 2048, minimum=1), device),
        cost=cost_freq_split, memory_bytes=mem_freq_split,
        needs_df_descending=True, needs_emit_col=True,
        doc="dense-head Gram × sparse-tail LIST-SCAN hybrid (beyond paper; "
            "cooc_gram + segment_hist kernels)",
    ))


_build_registry()
