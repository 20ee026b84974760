"""Roofline analysis of one fake dry run (NVIDIA H100 targets).

Terms (per rank, seconds):
    compute    = FLOPs / the cell's peak (PEAK_FLOPS, bf16, unless the cell
                 names another: the Gram's int8 tensor cores)
    memory     = bytes / HBM_BW
    collective = Σ collective result bytes / the bandwidth of the slowest
                 link its group crosses

The reference reads XLA's ``cost_analysis``, ``memory_analysis`` and the
collectives in the compiled HLO of the partitioned (per-device) module.
The port has no compiler to ask: :class:`Trace` is a dispatch mode that
watches one run of a cell under ``FakeTensorMode`` on a fake world, on
DTensors. It sees the local tensor operations each DTensor operation
becomes on this rank (rank 0), so every count is per rank, as XLA's are:

  * FLOPs by ``torch.utils.flop_counter``'s formulas on the local shapes
    (``FlopCounterMode`` on DTensors counts the global product);
  * bytes: each local operation's tensor inputs and outputs, views aside
    (no fusion, so an upper bound, as the reference's CPU-HLO bytes are);
  * collectives: the ``c10d`` and functional-collective operations that
    DTensor's redistributions and the explicit regions run, with their
    result bytes and their group's ranks;
  * memory: the arguments' local bytes, the outputs', and the peak of the
    bytes alive in tensors the run made (live storages).

Where DTensor has no sharding rule for an operation, the run takes it on
replicated operands (``dtensor_fallback``): the redistribution is traced
like any other, and the operation is named in ``Trace.fallback_ops`` of
every trace that runs it (the rule, once registered, stays for the
process).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref

import torch

# NVIDIA H100 80GB HBM3 (SXM5), 700 W, from NVIDIA's datasheet (dense)
PEAK_FLOPS = 989e12      # bf16 tensor-core FLOP/s
PEAK_INT8_OPS = 1979e12  # int8 tensor-core operations/s
HBM_BW = 3.35e12         # bytes/s
NVLINK_BW = 450e9        # bytes/s per direction, inside an 8-GPU node
IB_BW = 50e9             # bytes/s per GPU between nodes (InfiniBand NDR)
RANKS_PER_NODE = 8       # ranks laid 8 to a node in mesh order
HBM_BYTES = 80 * 2**30   # what "fits" is held against

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# local operation name → collective kind; the result is the operation's
# output, or for the in-place c10d ops the tensor(s) they write
_KIND = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "recv_": "collective-permute",  # a send's bytes are its peer's recv
}
_NO_BYTES = {"empty", "empty_like", "empty_strided", "zeros_like", "lift_fresh",
             "device", "sym_size", "sym_stride", "sym_numel", "wait_tensor",
             "send", "barrier", "_local_scalar_dense"}
_tls = threading.local()
# DTensor operation → the operations without a rule its sharding rests on
# (itself, or one of its decomposition): the rules registered stay for the
# process and DTensor caches each sharding, so a later trace learns from
# this map, as it dispatches the operation, what the first one was told
_NEEDS_FALLBACK: dict = {}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in torch.utils._pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _group_ranks(func, args, kwargs) -> list:
    """The global ranks of a collective's group: a c10d op's ProcessGroup
    argument, or a functional collective's group name."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in list(args) + list(kwargs.values()):
        if isinstance(a, dist.ProcessGroup):
            return dist.get_process_group_ranks(a)
        if isinstance(a, torch.ScriptObject):  # a c10d op's boxed group
            return dist.get_process_group_ranks(dist.ProcessGroup.unbox(a))
    names = [a for a in args if isinstance(a, str)]
    if names:
        return dist.get_process_group_ranks(_resolve_process_group(names[-1]))
    return list(range(dist.get_world_size()))


def link_bandwidth(ranks) -> float:
    """The bandwidth of the slowest link a group of global ranks crosses:
    NVLink inside one node of ``RANKS_PER_NODE``, InfiniBand across."""
    nodes = {r // RANKS_PER_NODE for r in ranks}
    return NVLINK_BW if len(nodes) <= 1 else IB_BW


@contextlib.contextmanager
def _not_counted():
    """DTensor's sharding propagation runs each operation once more, on
    global fake shapes, to learn the output's metadata: not this rank's
    work."""
    _tls.off = getattr(_tls, "off", 0) + 1
    try:
        yield
    finally:
        _tls.off -= 1


_PATCHED = False


def _patch_propagation() -> None:
    """Mark the sharding propagator's metadata runs as not counted, and
    give an operation without a sharding rule one that replicates every
    operand (named in the active :class:`Trace`'s ``fallback_ops``)."""
    global _PATCHED
    if _PATCHED:
        return
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    meta = ShardingPropagator._propagate_tensor_meta_non_cached
    prop = ShardingPropagator.propagate_op_sharding_non_cached

    def counted_meta(self, op_schema):
        with _not_counted():
            return meta(self, op_schema)

    def with_fallback(self, op_schema):
        try:
            return prop(self, op_schema)
        except NotImplementedError as e:
            if "sharding strategy" not in str(e):
                raise
            _replicate_rule(op_schema.op)
            name = str(op_schema.op)
            top = getattr(_tls, "dispatching", None)
            for op in {op_schema.op, top} - {None}:
                _NEEDS_FALLBACK.setdefault(op, set()).add(name)
            tr = getattr(_tls, "trace", None)
            if tr is not None:
                tr.fallback_ops.add(name)
            return prop(self, op_schema)

    ShardingPropagator._propagate_tensor_meta_non_cached = counted_meta
    ShardingPropagator.propagate_op_sharding_non_cached = with_fallback
    # a strided shard's size and offsets are index arithmetic on a small
    # arange: run it on real tensors (under fake ones it is data-dependent)
    from torch.distributed.tensor import placement_types as pt

    strided = getattr(pt, "_StridedShard", None)
    for name in ("local_shard_size_and_offset", "_local_shard_size_and_offset"):
        fn = getattr(strided, name, None) if strided is not None else None
        if fn is not None:
            setattr(strided, name, _real(fn))
    _PATCHED = True


def _real(fn):
    """``fn`` run outside any ``FakeTensorMode``."""
    import functools

    from torch._subclasses.fake_tensor import unset_fake_temporarily

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with unset_fake_temporarily(), _not_counted():
            return fn(*args, **kwargs)

    return run


def _replicate_rule(op) -> None:
    """Register a sharding for ``op`` that takes every DTensor operand
    replicated and gives replicated outputs."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import register_sharding

    from torch.distributed.tensor._dtensor_spec import DTensorSpec

    def rule(*args, **kwargs):
        ins = [Replicate() if isinstance(a, DTensorSpec) else None for a in args]
        return [([Replicate()] * max(1, len(op._schema.returns)), ins)]

    register_sharding(op)(rule)


class Trace(torch.utils._python_dispatch.TorchDispatchMode):
    """Per-rank FLOPs, bytes, collectives and live memory of the local
    operations run while active. Use inside ``FakeTensorMode``::

        with Trace(cell.args) as tr:
            out = cell.fn(*cell.args)
        tr.finish(cell.args, out)

    ``args``' storages are the arguments', not the run's temporaries.
    """

    def __init__(self, args=()):
        super().__init__()
        self._args = {id(t.untyped_storage()) for t in _local_tensors(args)}
        from torch.utils.flop_counter import flop_registry

        self._flops = flop_registry
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.collectives: list[dict] = []  # {"kind", "bytes", "ranks"}
        self.fallback_ops: set[str] = set()
        self.live = 0
        self.peak = 0
        self.memory: dict = {}
        self._seen: set = set()

    def __enter__(self):
        _patch_propagation()
        self._prev = getattr(_tls, "trace", None)
        _tls.trace = self
        return super().__enter__()

    def __exit__(self, *exc):
        _tls.trace = self._prev
        _tls.dispatching = None
        return super().__exit__(*exc)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen or key in self._args:
            return
        n = st.nbytes()
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n) -> None:
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            _tls.dispatching = func  # what DTensor now propagates
            self.fallback_ops |= _NEEDS_FALLBACK.get(func, set())
            return NotImplemented  # DTensor turns it into local operations
        out = func(*args, **kwargs)
        if getattr(_tls, "off", 0):
            return out
        name = func._overloadpacket.__name__
        kind = _KIND.get(name)
        if kind is not None:
            written = out if name in ("all_reduce", "all_gather_into_tensor",
                                      "reduce_scatter_tensor", "all_to_all_single") else args[0]
            nbytes = sum(_nbytes(t) for t in _tensors(written))
            self.collectives.append({"kind": kind, "bytes": nbytes,
                                     "ranks": _group_ranks(func, args, kwargs)})
            return out
        if func._overloadpacket in self._flops:
            self.flops += float(self._flops[func._overloadpacket](*args, **kwargs, out_val=out))
        outs = _tensors(out)
        if not func.is_view and name not in _NO_BYTES:
            self.bytes_accessed += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes_accessed += sum(_nbytes(t) for t in outs)
        if not func.is_view and name not in ("device", "wait_tensor"):
            for t in outs:
                self._track(t)
        return out

    def finish(self, args, outputs) -> None:
        """Record the memory of the run: arguments, outputs (less those
        that are arguments, updated in place: ``alias``) and the peak of
        the bytes alive in tensors the run made."""
        arg_st = {}
        for t in _local_tensors(args):
            arg_st[id(t.untyped_storage())] = t.untyped_storage().nbytes()
        out_st = {}
        for t in _local_tensors(outputs):
            out_st[id(t.untyped_storage())] = t.untyped_storage().nbytes()
        alias = sum(n for k, n in out_st.items() if k in arg_st)
        self.memory = {
            "argument_size_in_bytes": int(sum(arg_st.values())),
            "output_size_in_bytes": int(sum(out_st.values())),
            "temp_size_in_bytes": int(self.peak),
            "alias_size_in_bytes": int(alias),
        }
        self.memory["total_hbm_bytes"] = (
            self.memory["argument_size_in_bytes"] + self.memory["output_size_in_bytes"]
            + self.memory["temp_size_in_bytes"] - self.memory["alias_size_in_bytes"]
        )


def _local_tensors(tree) -> list:
    """The local blocks of every DTensor (and the plain tensors) in a tree
    of tensors, dicts, lists, tuples and modules."""
    from torch.distributed.tensor import DTensor

    out = []

    def walk(x):
        if isinstance(x, DTensor):
            out.append(x._local_tensor)
        elif isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, torch.nn.Module):
            for p in x.parameters():
                walk(p)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    return out


def collective_bytes(trace: Trace) -> dict:
    """Sum of result bytes per collective kind (this rank)."""
    out = {k: 0 for k in _COLLECTIVES}
    for c in trace.collectives:
        out[c["kind"]] += c["bytes"]
    return out


def collective_seconds(trace: Trace) -> float:
    """Each collective's bytes over the bandwidth of its group's slowest
    link, summed."""
    return float(sum(c["bytes"] / link_bandwidth(c["ranks"]) for c in trace.collectives))


def memory_stats(trace: Trace) -> dict:
    return dict(trace.memory)


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes_accessed: float
    coll_bytes: float
    coll_breakdown: dict
    n_chips: int
    model_flops: float
    hbm_resident_bytes: float = 0.0  # args + outputs + temps − alias
    coll_seconds: float | None = None  # per-link; None → coll_bytes / IB_BW
    peak_flops: float = PEAK_FLOPS  # the rate the cell's products run at

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        """Upper bound: every local operation's operand bytes (no fusion)."""
        return self.bytes_accessed / HBM_BW

    @property
    def t_memory_fused(self) -> float:
        """Fusion-adjusted estimate: each resident byte streamed about
        twice a step (read + write). Lower bound."""
        return 2.0 * self.hbm_resident_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        if self.coll_seconds is not None:
            return self.coll_seconds
        return self.coll_bytes / IB_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory_fused,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Roofline step time = max of the three overlappable terms (memory
        uses the fused estimate; the unfused bytes are reported too)."""
        return max(self.t_compute, self.t_memory_fused, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / total traced FLOPs (remat/dispatch waste)."""
        total = self.flops * self.n_chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Upper bound on model-FLOPs utilization implied by the roofline."""
        if self.t_bound == 0:
            return 0.0
        return (self.model_flops / self.n_chips / self.peak_flops) / self.t_bound

    def to_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops,
            "bytes_per_chip": self.bytes_accessed,
            "coll_bytes_per_chip": self.coll_bytes,
            "coll_breakdown": self.coll_breakdown,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_memory_fused_s": self.t_memory_fused,
            "t_collective_s": self.t_collective,
            "t_bound_s": self.t_bound,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
        }


def analyze(trace: Trace, n_chips: int, model_flops: float,
            peak_flops: float = PEAK_FLOPS) -> Roofline:
    coll = collective_bytes(trace)
    return Roofline(
        flops=trace.flops,
        bytes_accessed=trace.bytes_accessed,
        coll_bytes=float(sum(coll.values())),
        coll_breakdown=coll,
        n_chips=n_chips,
        model_flops=model_flops,
        hbm_resident_bytes=float(trace.memory.get("total_hbm_bytes", 0)),
        coll_seconds=collective_seconds(trace),
        peak_flops=peak_flops,
    )
