"""The mesh executor's collectives over a `torch.distributed` group.

Port of the reference's shard_map collectives (`jax.lax.all_gather`,
`psum`, `pmean`, `ppermute`, `axis_index`, `axis_size`) and its ring
combines (`repro.core.engine`'s `ring_neighbors`, `ring_combine`,
`ring_combine_block`, `_local_rows`).  A `MeshExecutor` names a process
group: each rank of the group holds one contiguous block of the node
axis, and every collective below runs over that group.

The program is SPMD: every rank runs the same Python with the same
global inputs (as the reference's shard_map takes global arrays), and
the collectives are issued in the same order on every rank.

* `all_gather(x, ex, dim)` — the ranks' blocks concatenated along `dim`
  in rank order (the reference's `tiled=True`);
* `psum` / `pmean` — an `all_reduce` SUM (then a division by the group's
  size, as `pmean` does);
* `ppermute(x, ex, perm)` — a point-to-point exchange by
  `batch_isend_irecv`; a rank that is its own peer (a one-rank group)
  copies locally, since NCCL has no send to self.

On meta tensors (the allocation-free dry run, `launch.dryrun`) `psum`
and `ppermute` make no c10d call: they return the result's shape and
dtype through the custom ops `repro_torch::meta_all_reduce` and
`repro_torch::meta_collective_permute`, whose only result is their meta
shape rule (a real tensor raises), so a dispatch mode (`launch.hlo_analysis`) sees each collective
as one op with its result bytes.  Nothing changes for CPU or CUDA
tensors.

`axis_executor(mesh, axis)` is the executor over one axis of a
`torch.distributed.device_mesh.DeviceMesh` (the LM mesh's consensus
axis).

A CUDA tensor needs an NCCL group and a CPU tensor a gloo group
(`check_device`); nothing falls back to another backend or device.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist


class MeshExecutor(NamedTuple):
    """Run the node axis sharded over the ranks of `group`
    (`torch.distributed` process group; None = the default group).
    `axis` names the axis as the reference's mesh axis does."""

    group: Optional[Any] = None
    axis: str = "data"


def axis_executor(mesh, axis: str = "data") -> MeshExecutor:
    """The executor over one named axis of a `DeviceMesh` (its group
    through this rank: the ranks that share every other coordinate).  On
    the LM mesh the consensus combines run so between replicas, each
    rank exchanging its own model shard with the peer at the same model
    coordinate; "pod" on the multi-pod mesh."""
    return MeshExecutor(mesh.get_group(axis), axis)


_BACKEND_OF = {"cuda": "nccl", "cpu": "gloo"}


def ensure_group(device) -> None:
    """Without an initialised default group, make a one-rank group
    in-process over a `HashStore` (no port, no network): NCCL for a CUDA
    `device`, gloo for the CPU.  A group that fails to initialise
    raises."""
    if not dist.is_initialized():
        dist.init_process_group(_BACKEND_OF[torch.device(device).type],
                                store=dist.HashStore(), rank=0,
                                world_size=1)


def _require_group(ex: MeshExecutor) -> None:
    if not dist.is_initialized():
        raise RuntimeError(
            "the mesh executor needs an initialised torch.distributed "
            "process group (init_process_group, or "
            "serving.admission.data_axis_mesh)")


def axis_size(ex: MeshExecutor) -> int:
    """Number of ranks along the executor's axis."""
    _require_group(ex)
    return dist.get_world_size(ex.group)


def axis_index(ex: MeshExecutor) -> int:
    """This rank's position along the executor's axis."""
    _require_group(ex)
    return dist.get_rank(ex.group)


def _peer(ex: MeshExecutor, r: int) -> int:
    """The global rank of group rank r (point-to-point ops take it)."""
    return r if ex.group is None else dist.get_global_rank(ex.group, r)


def check_device(ex: MeshExecutor, device) -> None:
    """Raise unless the group's backend serves `device`: NCCL for a CUDA
    device, gloo for the CPU."""
    _require_group(ex)
    dev = torch.device(device)
    backend = str(dist.get_backend(ex.group))
    if ":" in backend:                   # e.g. "cpu:gloo,cuda:nccl"
        backend = dict(p.split(":") for p in backend.split(",")).get(
            dev.type, "")
    want = _BACKEND_OF.get(dev.type)
    if backend != want:
        raise ValueError(
            f"the mesh executor's group runs {backend or 'no backend'} "
            f"for {dev.type}; a run on {dev} needs a {want} group")


def all_gather(x: torch.Tensor, ex: MeshExecutor,
               dim: int = 0) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim` in rank order."""
    n = axis_size(ex)
    x = x.contiguous()
    out = x.new_empty((n,) + x.shape)
    dist.all_gather(list(out.unbind(0)), x, group=ex.group)
    dim = dim % x.dim()
    shape = x.shape[:dim] + (n * x.shape[dim],) + x.shape[dim + 1:]
    return out.movedim(0, dim).reshape(shape)


@torch.library.custom_op("repro_torch::meta_all_reduce", mutates_args=())
def _meta_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """`psum`'s meta path: its result's shape and dtype (`register_fake`
    below), no c10d call.  A real tensor never takes it."""
    raise NotImplementedError("meta_all_reduce is psum's path on meta")


@torch.library.custom_op("repro_torch::meta_collective_permute",
                         mutates_args=())
def _meta_collective_permute(x: torch.Tensor) -> torch.Tensor:
    """`ppermute`'s meta path: its result's shape and dtype
    (`register_fake` below), no c10d call.  A real tensor never takes
    it."""
    raise NotImplementedError("meta_collective_permute is ppermute's path "
                              "on meta")


@_meta_all_reduce.register_fake
@_meta_collective_permute.register_fake
def _meta_result(x):
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


def psum(x: torch.Tensor, ex: MeshExecutor) -> torch.Tensor:
    """The sum of every rank's `x` (a new tensor)."""
    _require_group(ex)
    if x.is_meta:
        return _meta_all_reduce(x)
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=ex.group)
    return out


def pmean(x: torch.Tensor, ex: MeshExecutor) -> torch.Tensor:
    """The mean of every rank's `x`: `psum` over the group's size."""
    return psum(x, ex) / axis_size(ex)


def ppermute(x: torch.Tensor, ex: MeshExecutor, perm) -> torch.Tensor:
    """`x` sent along the (source, destination) pairs of `perm` (group
    ranks): each rank returns what its source sent, zeros where no pair
    names it as a destination (the reference's semantics)."""
    rank = axis_index(ex)
    dst = [d for s, d in perm if s == rank]
    src = [s for s, d in perm if d == rank]
    if dst == [rank] and src == [rank]:
        return x.clone(memory_format=torch.contiguous_format)
    if x.is_meta:
        return _meta_collective_permute(x)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = [dist.P2POp(dist.isend, x, _peer(ex, d), ex.group) for d in dst]
    ops += [dist.P2POp(dist.irecv, out, _peer(ex, s), ex.group)
            for s in src]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def local_rows(full: torch.Tensor, n_local: int, ex: MeshExecutor,
               dim: int = 0) -> torch.Tensor:
    """This rank's contiguous block of `n_local` rows of a replicated
    array along `dim` (a view)."""
    return full.narrow(dim, axis_index(ex) * n_local, n_local)


# ---------------------------------------------------------------------------
# Ring collectives (Eq. 27b on a ring of ranks)
# ---------------------------------------------------------------------------
def _ring_perms(n: int):
    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    return fwd, bwd


def ring_neighbors(x: torch.Tensor, ex: MeshExecutor):
    """(x_{i-1}, x_{i+1}) along the ring of ranks, by two `ppermute`s."""
    fwd, bwd = _ring_perms(axis_size(ex))
    return ppermute(x, ex, fwd), ppermute(x, ex, bwd)


def ring_combine(x: torch.Tensor, ex: MeshExecutor,
                 w_self: float = 1.0 / 3.0,
                 compute_dtype=None) -> torch.Tensor:
    """Eq. 27b with ring nearest-neighbour weights for ONE tensor per
    rank: x_i <- w_self x_i + w_n (x_{i-1} + x_{i+1}), w_n = (1 - w_self)
    / 2 (Eq. 47 on a cycle at w_self = 1/3).  `compute_dtype` upcasts
    AFTER the exchange, so the wire carries the storage dtype (bf16
    weights exchange bf16 bytes) while the weighted sum runs at the
    higher precision (the result stays in `compute_dtype`)."""
    left, right = ring_neighbors(x, ex)
    if compute_dtype is not None:
        x, left, right = (a.to(compute_dtype) for a in (x, left, right))
    w_n = (1.0 - w_self) / 2.0
    return w_self * x + w_n * (left + right)


def ring_boundaries(varphi: torch.Tensor, ex: MeshExecutor):
    """(phi_{i-1}, phi_{i+1}) for each of this rank's block of nodes
    along the node axis -2 of (..., n_local, P): the interior neighbours
    are the block shifted by one, and only the two boundary rows cross
    between ranks."""
    fwd, bwd = _ring_perms(axis_size(ex))
    prev_tail = ppermute(varphi[..., -1:, :], ex, fwd)
    next_head = ppermute(varphi[..., :1, :], ex, bwd)
    left = torch.cat([prev_tail, varphi[..., :-1, :]], -2)     # phi_{i-1}
    right = torch.cat([varphi[..., 1:, :], next_head], -2)     # phi_{i+1}
    return left, right


def ring_combine_block(varphi: torch.Tensor, ex: MeshExecutor,
                       w_self: float = 1.0 / 3.0) -> torch.Tensor:
    """Eq. 27b on a ring for a BLOCK of nodes per rank (node axis -2):
    the minimal-traffic exchange of `ring_boundaries`, then the same
    weighted sum as the single-array ring (so a one-rank group gives its
    bits)."""
    left, right = ring_boundaries(varphi, ex)
    w_n = (1.0 - w_self) / 2.0
    return w_self * varphi + w_n * (left + right)
