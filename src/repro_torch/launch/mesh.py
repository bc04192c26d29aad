"""Device meshes over the ranks of a `torch.distributed` world (port of
`repro.launch.mesh`).

A `torch.distributed.device_mesh.DeviceMesh` is the counterpart of the
reference's `jax.sharding.Mesh`: named axes ("data", "model", and "pod"
on the multi-pod mesh) laid over the ranks in row-major order, so the
ranks of one "model" group are consecutive.  Every rank of the world
calls the same function (a mesh is a collective object).

A mesh of one rank needs no launcher: without an initialised default
group, `make_test_mesh(1, 1)` makes a one-rank group in-process over a
`HashStore` (NCCL on the card, gloo on the CPU;
`dist.collectives.ensure_group`, as `serving.admission.data_axis_mesh`
does).  `axis_sizes` is `dist.sharding.axis_sizes`.  A larger mesh needs a world of
exactly its size (`torchrun`, or `launch.train --host_devices`); there is
nothing to fall back to, as `jax.make_mesh` has no devices to fake.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve
from repro_torch.dist import collectives
from repro_torch.dist.sharding import axis_sizes  # noqa: F401 (the API)


def _mesh(shape: tuple, names: tuple, device) -> DeviceMesh:
    dev = resolve(device)
    n = math.prod(shape)
    if not dist.is_initialized() and n != 1:
        raise RuntimeError(
            f"a {shape} mesh needs {n} ranks: start them with torchrun "
            f"(or launch.train --host_devices) before building it")
    collectives.ensure_group(dev)
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a {dict(zip(names, shape))} mesh needs {n} "
                         f"ranks; the world has {world}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 0, *,
                   device=None) -> DeviceMesh:
    """A ("data", "model") mesh, or ("pod", "data", "model") with
    `pod`, over the initialised world (None device means the card)."""
    if pod:
        return _mesh((pod, data, model), ("pod", "data", "model"), device)
    return _mesh((data, model), ("data", "model"), device)


def data_mesh(*, device=None) -> DeviceMesh:
    """A 1-D ("data",) mesh over every rank of the world (one rank
    alone): the counterpart of `serving.admission.data_axis_mesh`, and of
    the reference's `jax.make_mesh((n,), ("data",))`."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return _mesh((world,), ("data",), device)


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """The reference's production layout: (data=16, model=16) = 256
    ranks, or (pod=2, data=16, model=16) = 512 across two pods.  Raises
    unless the world has that many ranks."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), device)
    return _mesh((16, 16), ("data", "model"), device)


def n_chips(mesh) -> int:
    """The number of ranks (one card each) the mesh spans."""
    return math.prod(mesh.shape)
