"""Training loop driver: host data pipeline, steps, metrics, checkpoints
(port of `repro.training.trainer`).

`Trainer(cfg, mesh, dp_mode=...)` trains on `device` (None means the
CUDA device).  Without a mesh, "allreduce" runs on this process alone
and a consensus mode makes one (`launch.mesh.data_mesh`: a one-rank
group, or every rank of an initialised default group, one plain replica
each).  On a `DeviceMesh` the state is laid out by
`train_step.state_shardings` ("allreduce": over the whole mesh; a
consensus mode: each replica over its sub-mesh), each rank holding its
blocks only, and every rank draws
the same global batch from `Batcher`: the step takes its rows.
"""
from __future__ import annotations

import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.data.tokens import Batcher
from repro_torch.device import resolve
from repro_torch.dist import collectives
from repro_torch.launch import mesh as mesh_lib
from repro_torch.training import train_step as ts


class Trainer:
    def __init__(self, cfg: ModelConfig, mesh=None, *,
                 dp_mode: str = "allreduce",
                 consensus_axis: Optional[str] = None,
                 hyper: ts.TrainHyper = ts.TrainHyper(),
                 global_batch: int = 8, seq_len: int = 256, seed: int = 0,
                 ckpt_dir: Optional[str] = None, device=None,
                 use_kernels: bool = False):
        self.cfg, self.dp_mode, self.ckpt_dir = cfg, dp_mode, ckpt_dir
        self.device = resolve(device)
        if dp_mode != "allreduce":
            consensus_axis = consensus_axis or "data"
            if mesh is None:
                mesh = mesh_lib.data_mesh(device=self.device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"the mesh is on {mesh.device_type}, the "
                             f"trainer runs on {self.device}")
        self.mesh, self.axis = mesh, consensus_axis
        self.step_fn = ts.make_train_step(cfg, mesh, dp_mode=dp_mode,
                                          consensus_axis=consensus_axis,
                                          hyper=hyper,
                                          use_kernels=use_kernels)
        # the mesh's first rank prints and writes the checkpoints
        self.writes = mesh is None or \
            dist.get_rank() == int(mesh.mesh.flatten()[0])
        self.hyper = hyper
        self.state = ts.init_state(
            cfg, torch.Generator(self.device).manual_seed(seed),
            dp_mode=dp_mode, hyper=hyper, device=self.device, mesh=mesh,
            consensus_axis=consensus_axis)
        self.batcher = Batcher(cfg.vocab_size, global_batch, seq_len,
                               seed=seed, frontend_len=cfg.frontend_len,
                               d_model=cfg.d_model)
        self.history: list[dict] = []

    def next_batch(self) -> dict:
        """The next global batch, on the device (every rank draws the
        same; the step takes its rows)."""
        return ts.batch_to(self.batcher.next_batch(), self.device)

    def run(self, n_steps: int, log_every: int = 10) -> list[dict]:
        """`n_steps` steps; the metrics of the first step and of every
        `log_every`-th are read to the host, kept in `history` and printed
        (by the mesh's first rank)."""
        t0 = time.time()
        for i in range(n_steps):
            self.state, metrics = self.step_fn(self.state, self.next_batch())
            if (i + 1) % log_every == 0 or i == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = i + 1
                m["wall_s"] = time.time() - t0
                self.history.append(m)
                if self.writes:
                    print(f"step {i+1:5d} loss {m['loss']:.4f} "
                          f"lr {m['lr']:.2e} |g| {m['grad_norm']:.3f}"
                          + (f" resid {m['consensus_residual']:.2e}"
                             if "consensus_residual" in m else ""),
                          flush=True)
        return self.history

    def save(self, step: int) -> Optional[str]:
        """Write the state to `ckpt_dir/ckpt_{step:08d}.npz` in the
        reference's layout.  On a mesh every DTensor is gathered whole, a
        consensus mode gathers the replicas on a leading axis, the mesh's
        first rank writes, and every rank returns (or raises) once the
        file is written.  Returns the path (None without a `ckpt_dir`, or
        on another rank)."""
        if self.ckpt_dir is None:
            return None
        tree = ts.train_state_tree(self.state)
        if self.mesh is None:
            return ckpt.save(self.ckpt_dir, tree, step=step)
        if self.dp_mode != "allreduce":
            ex = collectives.axis_executor(self.mesh, self.axis)
            gather = lambda d: None if d is None else _map(
                d, lambda t: collectives.all_gather(t[None], ex))
            tree = tree._replace(
                params=gather(tree.params),
                opt=tree.opt._replace(mu=gather(tree.opt.mu),
                                      nu=gather(tree.opt.nu)),
                duals=gather(tree.duals))
        path, err = None, None
        if self.writes:
            try:
                path = ckpt.save(self.ckpt_dir, tree, step=step)
            except OSError as e:
                err = e
        failed = torch.tensor(float(err is not None), device=self.device)
        for d in range(self.mesh.ndim):        # a sum over the mesh
            if self.mesh.size(d) > 1:
                dist.all_reduce(failed, group=self.mesh.get_group(d))
        if float(failed):
            raise RuntimeError(f"the writing rank could not save the "
                               f"checkpoint of step {step}") from err
        return path

    def restore(self, step: int):
        """Load `ckpt_dir/ckpt_{step:08d}.npz` (the port's or the
        reference's `Trainer.save`, from any mesh; a consensus mode takes
        its replica's slice) and lay it out on this trainer's mesh."""
        arrays = ckpt.read_npz(ckpt._step_path(self.ckpt_dir, step))
        replica = (None if self.dp_mode == "allreduce"
                   else self.mesh.get_local_rank(self.axis))
        self.state = ts.train_state_from_arrays(
            self.cfg, arrays, dp_mode=self.dp_mode, device=self.device,
            replica=replica, hyper=self.hyper, mesh=self.mesh,
            consensus_axis=self.axis)


def _map(tree, fn):
    """`fn` on every tensor of a tree of dicts and lists, in a fixed
    order (the same collectives on every rank)."""
    if isinstance(tree, dict):
        return {k: _map(tree[k], fn) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)
