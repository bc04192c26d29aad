"""Training loop driver: host data pipeline, steps, metrics, checkpoints
(port of `repro.training.trainer`).

`Trainer(cfg, executor, dp_mode=...)` trains on `device` (None means the
CUDA device).  "allreduce" runs on this process alone.  A consensus mode
("diffusion", "admm") runs one replica on each rank of the mesh
executor's group (without one, `admission.data_axis_mesh(device=)`: a
one-rank group, or every rank of an initialised default group): every
rank draws the same global batch from `Batcher` and takes its contiguous
rows, as the reference's batch sharding over its data axis does.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.data.tokens import Batcher
from repro_torch.device import resolve
from repro_torch.dist import collectives
from repro_torch.dist.collectives import MeshExecutor
from repro_torch.serving import admission
from repro_torch.training import train_step as ts


class Trainer:
    def __init__(self, cfg: ModelConfig,
                 executor: Optional[MeshExecutor] = None, *,
                 dp_mode: str = "allreduce",
                 hyper: ts.TrainHyper = ts.TrainHyper(),
                 global_batch: int = 8, seq_len: int = 256, seed: int = 0,
                 ckpt_dir: Optional[str] = None, device=None,
                 use_kernels: bool = False):
        self.cfg, self.dp_mode, self.ckpt_dir = cfg, dp_mode, ckpt_dir
        self.device = resolve(device)
        if dp_mode != "allreduce" and executor is None:
            executor = admission.data_axis_mesh(device=self.device)
        if executor is not None:
            collectives.check_device(executor, self.device)
        self.executor = executor
        self.step_fn = ts.make_train_step(cfg, executor, dp_mode=dp_mode,
                                          hyper=hyper,
                                          use_kernels=use_kernels)
        self.rows = None
        self.rank = 0
        if dp_mode != "allreduce":
            n = collectives.axis_size(executor)
            self.rank = collectives.axis_index(executor)
            if global_batch % n:
                raise ValueError(f"global_batch={global_batch} must divide "
                                 f"over the group's {n} ranks")
            b = global_batch // n
            self.rows = slice(self.rank * b, (self.rank + 1) * b)
        self.state = ts.init_state(
            cfg, torch.Generator(self.device).manual_seed(seed),
            dp_mode=dp_mode, hyper=hyper, device=self.device)
        self.batcher = Batcher(cfg.vocab_size, global_batch, seq_len,
                               seed=seed, frontend_len=cfg.frontend_len,
                               d_model=cfg.d_model)
        self.history: list[dict] = []

    def next_batch(self) -> dict:
        """The next global batch's rows of this rank, on the device."""
        return ts.batch_to(self.batcher.next_batch(), self.device, self.rows)

    def run(self, n_steps: int, log_every: int = 10) -> list[dict]:
        """`n_steps` steps; the metrics of the first step and of every
        `log_every`-th are read to the host, kept in `history` and printed
        (by rank 0)."""
        t0 = time.time()
        for i in range(n_steps):
            self.state, metrics = self.step_fn(self.state, self.next_batch())
            if (i + 1) % log_every == 0 or i == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = i + 1
                m["wall_s"] = time.time() - t0
                self.history.append(m)
                if self.rank == 0:
                    print(f"step {i+1:5d} loss {m['loss']:.4f} "
                          f"lr {m['lr']:.2e} |g| {m['grad_norm']:.3f}"
                          + (f" resid {m['consensus_residual']:.2e}"
                             if "consensus_residual" in m else ""),
                          flush=True)
        return self.history

    def save(self, step: int) -> Optional[str]:
        """Write the state to `ckpt_dir/ckpt_{step:08d}.npz` in the
        reference's layout; a consensus mode gathers the replicas on a
        leading axis, rank 0 writes, and every rank returns (or raises)
        once the file is written.  Returns the path (None without a
        `ckpt_dir`, or on another rank)."""
        if self.ckpt_dir is None:
            return None
        tree = ts.train_state_tree(self.state)
        if self.dp_mode == "allreduce":
            return ckpt.save(self.ckpt_dir, tree, step=step)
        gather = lambda d: None if d is None else _map(
            d, lambda t: collectives.all_gather(t[None], self.executor))
        tree = tree._replace(params=gather(tree.params),
                             opt=tree.opt._replace(mu=gather(tree.opt.mu),
                                                   nu=gather(tree.opt.nu)),
                             duals=gather(tree.duals))
        path, err = None, None
        if self.rank == 0:
            try:
                path = ckpt.save(self.ckpt_dir, tree, step=step)
            except OSError as e:
                err = e
        failed = collectives.psum(torch.tensor(
            float(err is not None), device=self.device), self.executor)
        if float(failed):
            raise RuntimeError(f"rank 0 could not write the checkpoint "
                               f"of step {step}") from err
        return path

    def restore(self, step: int):
        """Load `ckpt_dir/ckpt_{step:08d}.npz` (the port's or the
        reference's `Trainer.save`; a consensus mode takes its rank's
        replica)."""
        arrays = ckpt.read_npz(ckpt._step_path(self.ckpt_dir, step))
        self.state = ts.train_state_from_arrays(
            self.cfg, arrays, dp_mode=self.dp_mode, device=self.device,
            replica=None if self.dp_mode == "allreduce" else self.rank)


def _map(tree, fn):
    """`fn` on every tensor of a tree of dicts and lists, in a fixed
    order (the same collectives on every rank)."""
    if isinstance(tree, dict):
        return {k: _map(tree[k], fn) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)
