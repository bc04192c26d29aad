"""Partitioning rules for the mesh paths (port of
`repro.dist.sharding`): the VB half (which leaves of a VB session's state
are row-sharded under the mesh executor) and the LM half (which tensor
dims of a language model land on which axes of a device mesh).

VB half.  A spec is the node axis of a leaf (an int: its rows are split
over the ranks, each holding one contiguous block) or None (replicated:
every rank holds the same value).  A spec given for a subtree applies to
each of its leaves, as a shard_map prefix spec does.  The rule: every
per-node array (the data leaves, phi, the topology carry's per-node part,
the stream's keys, permutations and SVRG anchors, the topology's
`shard_inputs` rows) shards its node axis 0; scalars (the ADMM penalty
and gate state, the stream's epoch) replicate; the (T, N) KL
trajectories shard axis 1.  A serving fleet's leaves carry a leading slot
axis: `fleet_spec` moves each node axis one to the right.
`local_tree` takes a rank's block of a global tree; `gather_tree` puts
the ranks' blocks back together (the executor's outputs), so every rank
ends with the complete state.

LM half.  A spec is a tuple with one entry per tensor dim: an axis name,
a tuple of names (the dim split over several axes, major first) or None
(replicated), entry for entry the reference's `PartitionSpec`.  The
policy (`spec_for`): an optional leading replica axis; the stacked-layer
(scan) axes never sharded; the LAST divisible payload dim on "model";
with `fsdp` the first other divisible dim on "data"; anything
indivisible replicated.  `placements` turns a spec into the DTensor
placements of a `DeviceMesh` (`Shard(d)` / `Replicate()`, the
counterpart of a `NamedSharding`), and `distribute` makes a module's
parameters DTensors by them.  Inside a forward pass the ambient mesh
(`use_mesh`) drives `constrain_batch_dim` / `constrain_last_dim_model`,
the reference's activation constraints: each is a `redistribute` of a
DTensor, and a no-op without an ambient mesh.
"""
from __future__ import annotations

import contextlib
import copy
import threading
from collections.abc import Mapping
from typing import Optional

import torch
from torch import nn
from torch.distributed.tensor import (DTensor, Partial, Placement,
                                      Replicate, Shard)
from torch.distributed.tensor.experimental import (implicit_replication,
                                                  local_map)

from repro_torch.dist import collectives

NODE = 0


def _is_spec(spec) -> bool:
    return spec is None or isinstance(spec, int)


def _map(fn, spec, tree):
    """fn(leaf, spec) over `tree` with `spec` a prefix of its structure
    (tuples, NamedTuples, lists, dicts; None leaves stay None)."""
    if tree is None:
        return None
    if _is_spec(spec):
        if isinstance(tree, torch.Tensor):
            return fn(tree, spec)
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(_map(fn, spec, v) for v in tree))
        if isinstance(tree, (tuple, list)):
            return type(tree)(_map(fn, spec, v) for v in tree)
        if isinstance(tree, dict):
            return {k: _map(fn, spec, v) for k, v in tree.items()}
        return tree                      # a host scalar: replicated
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, s, v) for s, v in zip(spec, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, s, v) for s, v in zip(spec, tree))
    if isinstance(tree, dict):
        return {k: _map(fn, spec[k], v) for k, v in tree.items()}
    raise TypeError(f"spec {spec!r} does not fit {type(tree).__name__}")


def vb_node_specs(data, *, has_carry: bool, n_local: int,
                  carry_specs=None, stream_specs=None):
    """(in_specs, out_specs) of the executor: the inputs (data, phi,
    carry, stream, *shard_inputs rows) and the outputs (phi, carry,
    stream, KLs (T, N), consensus error (T,)).  `carry_specs` is the
    topology's (`carry_specs()`), for carries that mix per-node rows with
    replicated scalars; `stream_specs` is `data.stream.state_specs`."""
    data_specs = _map(lambda _, s: s, NODE, data)
    carry_spec = (carry_specs if carry_specs is not None else NODE) \
        if has_carry else None
    in_specs = (data_specs, NODE, carry_spec, stream_specs) \
        + (NODE,) * n_local
    out_specs = (NODE, carry_spec, stream_specs, 1, None)
    return in_specs, out_specs


def fleet_spec(spec):
    """The spec of the same tree with a leading slot axis."""
    if _is_spec(spec):
        return None if spec is None else spec + 1
    if isinstance(spec, tuple) and hasattr(spec, "_fields"):
        return type(spec)(*(fleet_spec(s) for s in spec))
    if isinstance(spec, (tuple, list)):
        return type(spec)(fleet_spec(s) for s in spec)
    return {k: fleet_spec(s) for k, s in spec.items()}


def local_tree(tree, spec, ex, n_local: int):
    """This rank's block of `n_local` rows of every sharded leaf (a
    contiguous tensor); replicated leaves as they are."""
    def take(a, s):
        if s is None:
            return a
        return collectives.local_rows(a, n_local, ex, s).contiguous()

    return _map(take, spec, tree)


def gather_tree(tree, spec, ex):
    """Every sharded leaf's blocks of all ranks, concatenated along its
    node axis; replicated leaves as they are."""
    return _map(lambda a, s: a if s is None
                else collectives.all_gather(a, ex, s), spec, tree)


# ---------------------------------------------------------------------------
# LM half: the partitioning policy
# ---------------------------------------------------------------------------
def axis_sizes(mesh) -> dict:
    """{axis name: size} of a `DeviceMesh`, a plain mapping, or anything
    with `axis_names` and `devices.shape` (a JAX mesh, or a stand-in for
    the production mesh without its ranks)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def axis_size(mesh, name: str) -> int:
    """The size of axis `name` of `mesh` (1 where the mesh lacks it)."""
    return axis_sizes(mesh).get(name, 1)


def spec_for(shape, mesh, *, fsdp: bool = False, n_scan_axes: int = 0,
             replica_axis: Optional[str] = None) -> tuple:
    """The spec of a parameter of `shape` under the policy above."""
    rank = len(shape)
    spec: list = [None] * rank
    lead = 0
    if replica_axis is not None and rank > 0:
        spec[0] = replica_axis
        lead = 1
    lead += n_scan_axes
    sizes = axis_sizes(mesh)
    model_size = sizes.get("model", 1)
    data_size = sizes.get("data", 1)

    model_dim = None
    if model_size > 1:
        for ax in range(rank - 1, lead - 1, -1):
            if shape[ax] % model_size == 0 and shape[ax] >= 2 * model_size:
                model_dim = ax
                spec[ax] = "model"
                break
    if fsdp and data_size > 1 and replica_axis != "data":
        for ax in range(lead, rank):
            if ax == model_dim:
                continue
            if shape[ax] % data_size == 0 and shape[ax] >= 2 * data_size:
                spec[ax] = "data"
                break
    return tuple(spec)


def param_shardings(named_params: dict, mesh, *, fsdp: bool = False,
                    scanned: bool = False,
                    replica_axis: Optional[str] = None,
                    no_fsdp_keys: tuple = ()) -> dict:
    """{name: spec} for a model's named parameters (or AdamW moments, or
    duals: anything keyed by the port's parameter names).

    The reference stacks a homogeneous model's layers on a leading axis
    and, with `scanned`, marks one scan axis on EVERY leaf (the embedding
    table's vocab dim included); a consensus state carries a leading
    replica axis.  The port holds one tensor a layer and one replica a
    rank, so a leaf's spec is the reference's for the shape with those
    axes put back (`blocks.*` leaves get the layer axis, every leaf the
    replica axis), with their entries dropped again.  Leaves whose name
    has a part in `no_fsdp_keys` opt out of fsdp (locally dispatched MoE
    experts)."""
    n_scan = 1 if scanned else 0
    replicas = axis_sizes(mesh).get(replica_axis, 1) if replica_axis else 1
    out = {}
    for name, t in named_params.items():
        use_fsdp = fsdp and not (set(name.split(".")) & set(no_fsdp_keys))
        shape = tuple(t.shape)
        lead = ()
        if scanned and name.startswith("blocks."):
            lead = (1,)                   # the layer axis: never sharded
        if replica_axis is not None:
            lead = (replicas,) + lead
        spec = spec_for(lead + shape, mesh, fsdp=use_fsdp,
                        n_scan_axes=n_scan, replica_axis=replica_axis)
        out[name] = spec[len(lead):]
    return out


def axes_entry(axes):
    """A spec entry for a dim over `axes`: None for none, the name for
    one, the tuple for several (as a `PartitionSpec` normalises it)."""
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def batch_spec(mesh) -> tuple:
    """The batch dim over whichever of ("pod", "data") exist with size
    > 1 (the spec of dim 0; the other dims replicate)."""
    sizes = axis_sizes(mesh)
    axes = tuple(a for a in ("pod", "data") if sizes.get(a, 1) > 1)
    return (axes_entry(axes),) if axes else ()


def placements(spec, mesh) -> tuple:
    """The DTensor placements of `spec` on a `DeviceMesh`: `Shard(d)` on
    each mesh axis that names tensor dim d, `Replicate()` on the rest.  A
    dim split over several axes takes them in the mesh's order (major
    first), as the reference's tuple entries do."""
    names = tuple(mesh.mesh_dim_names)
    owner: dict = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        if list(axes) != sorted(axes, key=lambda a: names.index(a)
                                if a in names else -1) \
                or any(a not in names for a in axes):
            raise ValueError(f"spec {spec!r} does not fit the mesh axes "
                             f"{names}")
        for a in axes:
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in names)


# ---------------------------------------------------------------------------
# LM half: DTensors on a mesh
# ---------------------------------------------------------------------------
def local_shard(full: torch.Tensor, mesh, place) -> torch.Tensor:
    """This rank's block of a tensor every rank holds whole (a view): the
    shards are even, since the policy shards divisible dims only."""
    coord = mesh.get_coordinate()
    out = full
    for md, p in enumerate(place):
        if isinstance(p, Shard):
            n = mesh.size(md)
            if out.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(full.shape)} "
                                 f"does not split over {n} ranks")
            k = out.shape[p.dim] // n
            out = out.narrow(p.dim, coord[md] * k, k)
    return out


def to_dtensor(full: torch.Tensor, mesh, place) -> DTensor:
    """A DTensor of `full` (held whole and equal on every rank) with
    placements `place`, from this rank's block: no communication.  A
    block smaller than `full` is copied into storage of its own, so the
    whole tensor can be freed; a block that is all of it (a layout that
    splits nothing, as on a mesh of one rank) stays a view."""
    block = local_shard(full, mesh, place)
    if block.numel() != full.numel():
        block = block.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(block, mesh, tuple(place), run_check=False,
                              shape=full.shape, stride=full.stride())


def zeros(shape, dtype, device, mesh, place) -> DTensor:
    """A DTensor of zeros of global `shape` with placements `place`, each
    rank allocating only its block."""
    local_shape = local_shard(torch.empty(shape, device="meta"), mesh,
                              place).shape
    return DTensor.from_local(
        torch.zeros(local_shape, dtype=dtype, device=device), mesh,
        tuple(place), run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def distribute(module: nn.Module, mesh, specs: dict) -> nn.Module:
    """`module` with each parameter replaced by a DTensor parameter of
    its spec (`specs`: {name: spec}, as `param_shardings` gives) holding
    this rank's block (`to_dtensor`: a copy where the spec splits the
    parameter, which frees the whole one), `requires_grad` kept.  The
    module is changed in place and returned: `distribute_copy` keeps the
    original."""
    for name, p in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        d = to_dtensor(p.detach(), mesh, placements(specs[name], mesh))
        setattr(mod, leaf, nn.Parameter(d, requires_grad=p.requires_grad))
    return module


def distribute_copy(module: nn.Module, mesh, specs: dict) -> nn.Module:
    """A structural copy of `module` whose parameters are DTensors of
    this rank's blocks (`to_dtensor`: views of the original's storage
    where a spec splits nothing, copies of the blocks elsewhere)."""
    memo = {id(p): p for p in module.parameters()}
    return distribute(copy.deepcopy(module, memo), mesh, specs)


def full(t):
    """The whole tensor of a DTensor (gathered), a tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def local(t):
    """This rank's block of a DTensor, a tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


# ---------------------------------------------------------------------------
# LM half: the ambient mesh and the activation constraints
# ---------------------------------------------------------------------------
class _MeshState(threading.local):
    def __init__(self):
        self.stack: list = []


_STATE = _MeshState()


@contextlib.contextmanager
def use_mesh(mesh):
    """Ambient-mesh context (the counterpart of `compat.use_mesh`): the
    model's constraint sites and kernel adapters shard over `mesh`, and
    plain tensors met beside DTensors (positions, masks) count as
    replicated."""
    _STATE.stack.append(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _STATE.stack.pop()


def current_mesh():
    """The ambient mesh, or None."""
    return _STATE.stack[-1] if _STATE.stack else None


def dp_axes_for(batch: int, mesh=None) -> tuple:
    """The data-parallel axes ("pod", "data") of the mesh, of size > 1,
    that divide a batch of `batch` rows in turn."""
    sizes = axis_sizes(mesh if mesh is not None else current_mesh())
    axes, rem = [], batch
    for a in ("pod", "data"):
        s = sizes.get(a, 1)
        if s > 1 and rem % s == 0:
            axes.append(a)
            rem //= s
    return tuple(axes)


def as_dtensor(x, mesh) -> DTensor:
    """`x` as a DTensor on `mesh`: a plain tensor counts as replicated."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def relayout(x: DTensor, mesh, place) -> DTensor:
    """`x` with placements `place` (a `redistribute`).  Where the two
    layouts differ only on mesh axes of size 1 (a shard, a partial sum
    and a replica of one rank hold the same values) the local tensor is
    relabelled instead: no copy (DTensor's redistribute would copy)."""
    place = tuple(place)
    if tuple(x.placements) == place:
        return x
    if all(a == b or mesh.size(i) == 1
           for i, (a, b) in enumerate(zip(x.placements, place))):
        return DTensor.from_local(x.to_local(), mesh, place,
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())
    return x.redistribute(mesh, place)


def constrain_batch_dim(x):
    """Re-assert that dim 0 (batch) is sharded over the data-parallel
    axes (and replicated over the rest)."""
    mesh = current_mesh()
    if mesh is None:
        return x
    x = as_dtensor(x, mesh)
    return relayout(x, mesh, placements_for(mesh, batch=x.shape[0]))


def constrain_last_dim_model(x):
    """Pin the trailing dim to the "model" axis (head_dim-sharded decode;
    every other dim replicated, as the reference's spec says)."""
    mesh = current_mesh()
    if mesh is None:
        return x
    m = axis_sizes(mesh).get("model", 1)
    if m <= 1 or x.shape[-1] % m != 0:
        return x
    x = as_dtensor(x, mesh)
    place = tuple(Shard(x.ndim - 1) if a == "model" else Replicate()
                  for a in mesh.mesh_dim_names)
    return relayout(x, mesh, place)


def placements_for(mesh, *, batch: Optional[int] = None, batch_dim: int = 0,
                   model_dim: Optional[int] = None) -> tuple:
    """Placements of a tensor in a per-shard region: dim `batch_dim` (a
    batch of `batch` rows; None: no batch dim) over the dp axes that
    divide it, dim `model_dim` over "model" (None: replicated there),
    every other axis replicated."""
    dp = dp_axes_for(batch, mesh) if batch is not None else ()
    out = []
    for a in mesh.mesh_dim_names:
        if a in dp:
            out.append(Shard(batch_dim))
        elif a == "model" and model_dim is not None:
            out.append(Shard(model_dim))
        else:
            out.append(Replicate())
    return tuple(out)


def region(fn, mesh, in_placements, out_placements):
    """`fn` run on each rank's blocks (`local_map`): its DTensor inputs
    are redistributed to `in_placements` (one entry an argument, None for
    a non-tensor), it sees their local tensors, and its outputs become
    DTensors with `out_placements`.  The model's per-head and per-row
    computations (attention, the SSD and RG-LRU scans, the convolutions,
    MoE routing) run so, exactly: each shard holds whole heads or whole
    rows.  An input replicated over a mesh axis that another input is
    split on (a parameter beside a batch-sharded activation) is used by
    every shard along it: its gradient is the sum of theirs, `Partial`
    there, which its layout then reduces."""
    if all(isinstance(pl, Placement) for pl in out_placements):
        out_placements = list(out_placements)       # one output
    in_placements = tuple(in_placements)
    split = {i for i in range(mesh.ndim) if mesh.size(i) > 1 and any(
        pl is not None and isinstance(pl[i], Shard) for pl in in_placements)}
    grad_placements = tuple(
        None if pl is None else tuple(
            Partial() if i in split and isinstance(p, Replicate) else p
            for i, p in enumerate(pl))
        for pl in in_placements)
    mapped = local_map(fn, out_placements=out_placements,
                       in_placements=in_placements,
                       in_grad_placements=grad_placements, device_mesh=mesh,
                       redistribute_inputs=True)

    def call(*args):
        return mapped(*(relayout(a, mesh, pl) if isinstance(a, DTensor)
                        and pl is not None else a
                        for a, pl in zip(args, in_placements)))

    return call


def model_dim_of(t) -> Optional[int]:
    """The tensor dim a DTensor shards over its mesh's "model" axis
    (None: replicated there, or not a DTensor)."""
    if not isinstance(t, DTensor) or \
            "model" not in t.device_mesh.mesh_dim_names:
        return None
    p = t.placements[t.device_mesh.mesh_dim_names.index("model")]
    return p.dim if isinstance(p, Shard) else None


def unshard_model(x):
    """`x` replicated over the ambient mesh's "model" axis (its other
    placements kept): before a split or a per-channel region of a dim
    the projections left model-sharded.  A no-op without a mesh."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor) or model_dim_of(x) is None:
        return x
    i = x.device_mesh.mesh_dim_names.index("model")
    place = list(x.placements)
    place[i] = Replicate()
    return relayout(x, x.device_mesh, place)


def rows_region(fn, batched: tuple, whole: tuple = (), n_out: int = 1):
    """`fn(*batched, *whole)` on each rank's rows of the `batched`
    tensors (dim 0, over the dp axes that divide it) with the `whole`
    ones (parameters) replicated, and "model" replicated throughout: the
    per-row work of small tensors (the convolutions, a decode step's
    recurrence).  Its `n_out` outputs each have the rows as dim 0.
    Without an ambient mesh, `fn` on the tensors themselves."""
    mesh = current_mesh()
    if mesh is None:
        return fn(*batched, *whole)
    rows = placements_for(mesh, batch=batched[0].shape[0])
    rep = placements_for(mesh)
    return region(fn, mesh, (rows,) * len(batched) + (rep,) * len(whole),
                  rows if n_out == 1 else (rows,) * n_out)(*batched, *whole)
