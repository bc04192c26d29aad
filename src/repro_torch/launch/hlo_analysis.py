"""Roofline terms of one step, counted without running it on a device
(port of `repro.launch.hlo_analysis`).

compute term    = FLOPs / (chips * PEAK_FLOPS)
memory term     = bytes / (chips * HBM_BW)
collective term = collective_bytes / (chips * ICI_BW)

The reference reads FLOPs and bytes from XLA's `cost_analysis()` of the
compiled per-device program and parses the collectives out of its HLO
text.  The port compiles nothing: `analyze` runs the step once, on meta
tensors (`launch.specs`: DTensors whose local shards are meta, so
nothing is allocated), under one counting `TorchDispatchMode`
(`Counter`), which sees every op a rank would run on its local shards:

* FLOPs: `torch.utils.flop_counter`'s formulas, over the local ops only
  (an op on DTensors is handed on to DTensor, whose local ops come back
  to the mode; the global-shape op that DTensor's sharding propagation
  runs under its own `FakeTensorMode` is not counted).  The kernels'
  custom ops (`repro_torch::flash_attention`, `repro_torch::ssd_scan`)
  count by their registered formulas (`kernels.*.op_count`).
* Bytes accessed: each local op's input and output bytes, views and
  empty allocations excluded.  An upper bound, as HLO's "bytes accessed"
  is: it sees no fusion.
* Collectives: the kind, count and result bytes of DTensor's
  `_c10d_functional` ops, of a process group's own `c10d` ops, and of
  the mesh executor's meta collectives (`dist.collectives`: `psum` as
  all-reduce, `ppermute` as collective-permute), keyed as the
  reference's `collective_bytes`.
* Memory: the local bytes of the arguments and outputs (exact), and the
  peak of the local intermediates alive at once (`temp_size_in_bytes`),
  tracked from the storages the ops create and the tensors that still
  hold them: an estimate, since meta has no allocator, and it sees no
  allocator rounding, caching or workspace.

The constants are one NVIDIA H100 SXM's (NVIDIA's data sheet, dense
rates): 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM3.  The
link term takes the slowest link that a 16-wide mesh axis crosses: a
16 x 16 mesh spans 32 hosts of 8 cards (DGX H100), so an axis of 16
leaves its host, and each card reaches the others through its own
400 Gb/s InfiniBand NIC, 50e9 B/s (NVLink inside the host is 450 GB/s
each way).  `PEAK_F32_FLOPS` (f32 outside the tensor cores) and
`PEAK_F64_TC_FLOPS` (f64 on the tensor cores) are the same sheet's, for
the kernels' bounds (`chip_smoke.py`).
"""
from __future__ import annotations

import time
import weakref
from dataclasses import dataclass, field

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# NVIDIA H100 SXM (per card), dense rates
PEAK_FLOPS = 989e12        # bf16 FLOP/s on the tensor cores
HBM_BW = 3.35e12           # bytes/s
ICI_BW = 50e9              # bytes/s: one 400 Gb/s NIC, the axis's slowest
PEAK_F32_FLOPS = 67e12     # f32 FLOP/s outside the tensor cores
PEAK_F64_TC_FLOPS = 67e12  # f64 FLOP/s on the tensor cores (DMMA)

# op (overload packet name) -> the reference's collective kind
COLLECTIVES = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    # a process group's own ops (`dist.all_reduce` and kin: the decode's
    # head_dim partial sums)
    "c10d.allreduce_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "repro_torch.meta_all_reduce": "all-reduce",
    "repro_torch.meta_collective_permute": "collective-permute",
}
# the kernels' custom ops, counted by name
KERNEL_OPS = {"repro_torch.flash_attention": "flash_attention",
              "repro_torch.ssd_scan": "ssd_scan"}
# ops that move no bytes: shape queries and bare allocations
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "_wrap_tensor_autograd", "wait_tensor",
             "size", "sym_size", "stride", "sym_stride", "numel",
             "sym_numel", "dim", "is_contiguous", "storage_offset",
             "sym_storage_offset"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class CollectiveStats:
    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def add(self, kind: str, nbytes: int) -> None:
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + nbytes
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1


class Counter(TorchDispatchMode):
    """Counts the local ops run under it: FLOPs, bytes accessed,
    collectives, the kernels' op calls, and the live bytes of the
    storages the ops create (current and peak).  An op on DTensors is
    handed on to DTensor (its local ops come back here); ops run under a
    `FakeTensorMode` (DTensor's shape propagation) are not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives = CollectiveStats()
        self.kernel_calls: dict = {}
        self.live = 0
        self.peak = 0
        self._holders: dict = {}     # storage id -> [tensors alive, bytes]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if any(isinstance(m, FakeTensorMode)
               for m in _get_current_dispatch_mode_stack()):
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry and not func.is_view:
            # a composite op (under inference mode) counts by its parts,
            # as FlopCounterMode counts it
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        name = str(packet)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if name in COLLECTIVES:
            self.collectives.add(COLLECTIVES[name],
                                 sum(_nbytes(t) for t in outs))
        elif not func.is_view and packet.__name__ not in _NO_BYTES:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        if name in KERNEL_OPS:
            key = KERNEL_OPS[name]
            self.kernel_calls[key] = self.kernel_calls.get(key, 0) + 1
        for t in outs:
            self._hold(t)
        return out

    def _hold(self, t: torch.Tensor) -> None:
        """Track `t`'s storage while some tensor made here holds it."""
        st = t.untyped_storage()
        key = st._cdata
        entry = self._holders.get(key)
        if entry is None:
            entry = self._holders[key] = [0, st.nbytes()]
            self.live += entry[1]
            self.peak = max(self.peak, self.live)
        entry[0] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        entry = self._holders.get(key)
        if entry is None:
            return
        entry[0] -= 1
        if entry[0] == 0:
            self.live -= entry[1]
            del self._holders[key]


def _tensors(tree):
    """The tensors of `tree` (an `nn.Module` gives its parameters and
    buffers)."""
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.nn.Module):
            yield from leaf.parameters()
            yield from leaf.buffers()
        elif isinstance(leaf, torch.Tensor):
            yield leaf


def local_bytes(tree) -> int:
    """The bytes of the local storage of every tensor in `tree` (a
    DTensor's local shard), each storage once."""
    seen: dict = {}
    for t in _tensors(tree):
        st = (t.to_local() if isinstance(t, DTensor) else t).untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


@dataclass
class Counts:
    """What one counting run saw (per device)."""
    flops: float
    hbm_bytes: float
    collectives: CollectiveStats
    kernel_calls: dict
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    seconds: float


def count(fn, inputs: dict) -> Counts:
    """Run `fn(**inputs)` once under a `Counter`."""
    args = local_bytes(inputs)
    t0 = time.perf_counter()
    with Counter() as c:
        out = fn(**inputs)
        peak = c.peak
    seconds = time.perf_counter() - t0
    return Counts(flops=float(c.flops), hbm_bytes=float(c.bytes),
                  collectives=c.collectives, kernel_calls=c.kernel_calls,
                  argument_bytes=args, output_bytes=local_bytes(out),
                  temp_bytes=peak, seconds=seconds)


@dataclass
class Roofline:
    """All raw quantities are PER-DEVICE: the counting run sees one
    rank's local ops, so the FLOPs, bytes and collective bytes are one
    card's.  The `X / (chips * peak)` formulas are therefore applied with
    the global `X = per_device * chips`, i.e. t = per_device_X / peak,
    with any imbalance the layout leaves (replicated work) included."""

    flops: float               # per-device FLOPs
    hbm_bytes: float           # per-device bytes accessed (upper bound:
    #                            no fusion)
    coll_bytes: float          # per-device collective result bytes
    n_chips: int
    model_flops: float = 0.0   # 6*N*D analytic, GLOBAL
    coll_detail: dict = field(default_factory=dict)
    coll_counts: dict = field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / ICI_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """(model FLOPs per chip) / (counted FLOPs per chip): <1 under
        remat / redundant compute; >1 would indicate sharding that skips
        work."""
        if not self.flops:
            return 0.0
        return (self.model_flops / self.n_chips) / self.flops

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "n_chips": self.n_chips,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "coll_detail": self.coll_detail,
            "coll_counts": self.coll_counts,
        }


def roofline(counts: Counts, n_chips: int,
             model_flops: float = 0.0) -> Roofline:
    """The roofline of one counting run."""
    stats = counts.collectives
    return Roofline(flops=counts.flops, hbm_bytes=counts.hbm_bytes,
                    coll_bytes=float(stats.total_bytes), n_chips=n_chips,
                    model_flops=model_flops,
                    coll_detail=dict(stats.bytes_by_kind),
                    coll_counts=dict(stats.count_by_kind))


def analyze(fn, inputs: dict, n_chips: int,
            model_flops: float = 0.0) -> Roofline:
    """The roofline of `fn(**inputs)`, counted in one run."""
    return roofline(count(fn, inputs), n_chips, model_flops)


def extrapolate_layers(c1: Roofline, c2: Roofline, n_layers: int) -> Roofline:
    """Given rooflines of otherwise identical 1-layer and 2-layer
    programs, the per-layer marginal cost is (c2 - c1) and the L-layer
    total is c1 + (L-1)*(c2 - c1).  Exact for homogeneous stacks, whose
    layers run the same ops on the same shapes."""
    def ext(a, b):
        return a + (n_layers - 1) * (b - a)

    detail = {k: ext(c1.coll_detail.get(k, 0), c2.coll_detail.get(k, 0))
              for k in set(c1.coll_detail) | set(c2.coll_detail)}
    counts = {k: ext(c1.coll_counts.get(k, 0), c2.coll_counts.get(k, 0))
              for k in set(c1.coll_counts) | set(c2.coll_counts)}
    return Roofline(
        flops=ext(c1.flops, c2.flops),
        hbm_bytes=ext(c1.hbm_bytes, c2.hbm_bytes),
        coll_bytes=ext(c1.coll_bytes, c2.coll_bytes),
        n_chips=c1.n_chips, model_flops=c1.model_flops,
        coll_detail=detail, coll_counts=counts)


def memory_per_device(counts: Counts) -> dict:
    """The reference's keys: the arguments' and outputs' local bytes
    (exact), the peak of live intermediates (an estimate), and no
    generated code."""
    return {"argument_size_in_bytes": counts.argument_bytes,
            "output_size_in_bytes": counts.output_bytes,
            "temp_size_in_bytes": counts.temp_bytes,
            "generated_code_size_in_bytes": None}
