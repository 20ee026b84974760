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
methods matters. LIST-SCAN costs O(Σ len²) element work + per-posting
traversal + a V-wide accumulator per live row.

This package registers LIST-SCAN on the host (``list-scan``, kind
``paper``) and on the GPU (``list-scan-segment``, kind ``gpu``: the
batched histogram on the hand-written ``segment_hist`` kernel). The other
methods of the reference package are not ported yet.
"""

from __future__ import annotations

import dataclasses
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
# implementations)
# ---------------------------------------------------------------------------

ELEM = 1.0          # one vectorized element op
CALL = 8.0          # cheap numpy dispatch / intersection call overhead
PY_LOOP = 48.0      # Python-level per-iteration overhead (doc fetch, slicing)


def cost_list_scan(s: CollectionStats, kw: Mapping) -> float:
    return (
        2.0 * CALL * s.live_vocab               # per-row bookkeeping
        + 2.0 * PY_LOOP * s.num_postings        # per-(term, doc) inner loop
        + 2.0 * ELEM * 2.0 * s.pair_occurrences  # histogram increments
        + 0.5 * ELEM * s.live_vocab * s.vocab_size  # row clear + nonzero scan
    )


# working-set estimates (bytes) -------------------------------------------------


def mem_list_scan(s: CollectionStats, kw: Mapping) -> float:
    return 8.0 * s.vocab_size + 8.0 * s.num_postings  # row acc + index


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
    kind: str  # "paper" (host) | "gpu" (runs its kernels on ``device``)
    params: tuple[Param, ...] = ()
    cost: Callable[[CollectionStats, Mapping], float] = cost_list_scan
    memory_bytes: Callable[[CollectionStats, Mapping], float] = mem_list_scan
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
    # deferred import: the method module imports only data/ + types
    from repro_torch.core.list_scan import count_list_scan, count_list_scan_segment

    register(MethodSpec(
        "list-scan", count_list_scan, "paper",
        params=(_P("rows_per_batch", int, 64, minimum=1,
                   doc="primaries per batched bincount histogram"),),
        cost=cost_list_scan, memory_bytes=mem_list_scan,
        doc="term-order inverted+forward traversal (§2); best asymptotics, "
            "batched-histogram hot loop",
    ))
    register(MethodSpec(
        "list-scan-segment", count_list_scan_segment, "gpu",
        params=(_P("rows_per_batch", int, 64, minimum=1),
                _P("device", str, "cuda",
                   doc="'cuda': segment_hist kernel; 'cpu': plain PyTorch")),
        cost=cost_list_scan, memory_bytes=mem_list_scan,
        doc="LIST-SCAN as batched segment histograms on the device",
    ))


_build_registry()
