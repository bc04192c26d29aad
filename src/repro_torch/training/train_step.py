"""Training step factory — classical and consensus (paper-technique) modes
(port of `repro.training.train_step`).

dp_mode:
  "allreduce" — baseline (cVB analogue): one parameter set.  Without a
      mesh, trained on the whole batch this process holds; on a device
      mesh (`launch.mesh`), data-parallel over the data (and pod) axes,
      the parameters model-sharded and, with `cfg.fsdp`, data-sharded
      (`state_shardings`); DTensor's backward leaves the gradients as
      partial sums, and their redistribution to the parameters' layout is
      the gradient all-reduce (or reduce-scatter).
  "diffusion" — dSVB analogue (Eq. 27): one replica per coordinate of
      the consensus axis (`consensus_axis`, "data" by default; "pod" on
      the multi-pod mesh), model-sharded inside over the replica's
      sub-mesh (plain tensors on a mesh of the consensus axis alone, as
      the reference's 1-D ("data",) mesh); a local AdamW step on the
      replica's rows of the global batch, then the nearest-neighbour ring
      combine.
  "admm" — dVB-ADMM analogue (Eqs. 38a/39/40): per-replica parameters plus
      aggregate duals; a primal/dual consensus round per step.

The consensus steps run SPMD, as the reference's shard_map over its
consensus axis does: every rank runs the same step on its replica's
block and its rows, and the combines run between replicas over the
axis's group (`collectives.axis_executor`): each rank exchanges
its own model shard with the peer at the same model coordinate (exact:
the combines are elementwise).  The loss, ce, gradient norm and lr are
averaged over the replicas (`pmean`), the ADMM residual norms are
global, and `consensus_residual` is the replica's own (the reference's
replicated output is its first device's).  The state holds the replica
as an `LM` (parameters with gradients on; DTensors on a mesh), the AdamW
moments and duals as {name: f32 tensor} dicts laid out as the
parameters, `step` and the AdamW count as ints, and the ADMM penalty
`rho` as a float32 scalar tensor (dynamic state: residual balancing
moves it when `TrainHyper.adaptive_rho`).  A step updates the state in
place and returns it with the step advanced.

The JAX package cannot differentiate its Pallas kernels, and has no
backward kernel; training runs the plain forward under autograd (its
default `use_kernels=False`): `make_train_step(use_kernels=True)` raises,
and so do the kernel wrappers on inputs that require gradients (nothing
is silently detached).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.dist import collectives, sharding
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw, consensus, schedules

DP_MODES = ("allreduce", "diffusion", "admm")


class TrainState(NamedTuple):
    params: model_lib.LM
    opt: adamw.AdamState
    duals: Optional[dict]     # ADMM only
    step: int
    rho: Optional[torch.Tensor] = None   # ADMM penalty, dynamic state


class TrainHyper(NamedTuple):
    peak_lr: float = 3e-4
    warmup: int = 200
    total_steps: int = 10000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # consensus knobs (paper defaults)
    w_self: float = 1.0 / 3.0   # Eq. 47 nearest-neighbour on a ring
    rho: float = 0.5            # ADMM penalty (Remark 3); initial value —
    #                             the live value is TrainState.rho
    xi: float = 0.05            # kappa ramp (Eq. 40)
    # residual balancing of rho across training steps (Boyd Sec. 3.4.1,
    # the VB engine's rule via optim.consensus.adapt_rho)
    adaptive_rho: bool = False
    rho_mu: float = 10.0        # grow when ||r|| > mu ||s||, shrink flipped


def loss_fn(cfg: ModelConfig, params: model_lib.LM, batch: dict, *,
            use_kernels: bool = False):
    """(loss, {"ce", "aux"}): next-token cross entropy over the positions
    at or past `frontend_len`, plus `router_aux_weight` x the MoE router
    loss.  CE is logsumexp minus the label's logit (a gather: the
    reference's one-hot sum picks the same logit, without a (B, S, V)
    mask).  With `use_kernels` and gradients on, the kernels raise: they
    have no backward."""
    tokens = batch["tokens"]
    out = model_lib.forward(cfg, params, tokens, batch.get("frontend"),
                            use_kernels=use_kernels)
    logits = out["logits"][:, :-1, :]
    labels = tokens[:, 1:]
    mask = (torch.arange(labels.shape[1], device=tokens.device)[None, :]
            >= cfg.frontend_len)
    mask = mask.expand(labels.shape).float()
    # each row's logits are whole on its rank (the forward pins them to
    # the batch layout), so the CE terms are per-row work
    nll = sharding.rows_region(_token_nll, (logits, labels))
    ce = torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)
    loss = ce + cfg.router_aux_weight * out["aux_loss"]
    return loss, {"ce": ce, "aux": out["aux_loss"]}


def _token_nll(logits, labels):
    """logsumexp minus the label's logit, per token."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels[..., None].long())[..., 0]
    return lse - ll


def init_state(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               *, dp_mode: str = "allreduce",
               hyper: Optional[TrainHyper] = None, device=None,
               params: Optional[model_lib.LM] = None, mesh=None,
               consensus_axis: Optional[str] = None) -> TrainState:
    """A fresh state: `params` (default: an `LM` drawn from `generator`,
    seed 0 on the device), gradients turned on, zero moments, zero duals
    and `rho = hyper.rho` for ADMM.  In a consensus mode every rank draws
    the same replica from the same seed (the reference broadcasts one
    draw to every replica).  On a `DeviceMesh` the parameters are laid
    out by `state_shardings` over the replica's sub-mesh (the whole mesh
    for "allreduce"; `consensus_axis` defaults to "data"), each rank
    keeping its blocks, and the moments and duals are made in their
    layout: no rank holds a whole one.  Pass the SAME `hyper` here and
    to `make_train_step`."""
    if dp_mode not in DP_MODES:
        raise ValueError(f"dp_mode must be one of {DP_MODES}: {dp_mode!r}")
    hyper = hyper if hyper is not None else TrainHyper()
    if params is None:
        params = model_lib.LM(cfg, device=device, generator=generator)
    params.requires_grad_(True)
    if mesh is not None:
        axis = None if dp_mode == "allreduce" else consensus_axis or "data"
        sub = replica_mesh(mesh, axis)
        if sub is not None:
            sharding.distribute(params, sub, _specs(
                adamw.named(params), cfg, mesh, replica_axis=axis))
    dev = params.device
    duals = (consensus.admm_init_duals(adamw.named(params))
             if dp_mode == "admm" else None)
    rho = (torch.tensor(hyper.rho, dtype=torch.float32, device=dev)
           if dp_mode == "admm" else None)
    return TrainState(params=params, opt=adamw.init(params), duals=duals,
                      step=0, rho=rho)


# ---------------------------------------------------------------------------
# The state in the reference's checkpoint layout
# ---------------------------------------------------------------------------
def train_state_tree(state: TrainState) -> TrainState:
    """A `TrainState` as the reference's tree, for `ckpt.save`: the
    params and the moments (and duals) as JAX params trees
    (`ckpt.lm_tree`; a DTensor gathered whole, a collective every rank of
    its mesh makes), the count and step as ints (written int32), rho as
    a float32 scalar."""
    cfg = state.params.cfg
    tree = lambda d: ckpt.lm_tree(cfg, {n: sharding.full(t).detach()
                                        for n, t in d.items()})
    opt = adamw.AdamState(mu=tree(state.opt.mu), nu=tree(state.opt.nu),
                          count=state.opt.count)
    return TrainState(
        params=tree(adamw.named(state.params)), opt=opt,
        duals=None if state.duals is None else tree(state.duals),
        step=state.step, rho=state.rho)


def train_state_from_arrays(cfg: ModelConfig, arrays: dict, *,
                            dp_mode: str = "allreduce", device,
                            replica: Optional[int] = None,
                            hyper: Optional[TrainHyper] = None, mesh=None,
                            consensus_axis: Optional[str] = None
                            ) -> TrainState:
    """A `TrainState` on `device` from a training state's arrays
    ({keystr path: array}, as `ckpt.read_npz` gives them, in the
    reference's layout: `.params[...]`, `.opt.mu[...]`, `.opt.nu[...]`,
    `.opt.count`, `.duals[...]` (ADMM), `.step`, `.rho` (ADMM)).  A
    consensus mode's file from the reference (or the port's
    `Trainer.save`) carries a leading replica axis on every params,
    moments and duals leaf: `replica` takes one (a rank takes its own).
    `mesh` / `consensus_axis` lay the state out as `init_state` does: each
    rank reads its blocks of the arrays into its own."""
    def get(key):
        if key not in arrays:
            raise KeyError(f"checkpoint missing {key}")
        return arrays[key]

    def load(prefix: str, into: dict, what: str) -> None:
        ckpt._load_named(cfg, ckpt._lm_named(cfg, arrays, prefix, replica),
                         into, what)

    state = init_state(cfg, dp_mode=dp_mode, hyper=hyper, mesh=mesh,
                       consensus_axis=consensus_axis,
                       params=model_lib.LM(cfg, device=device, init=False))
    load(".params", adamw.named(state.params), "params")
    for field in ("mu", "nu"):
        load(f".opt.{field}", getattr(state.opt, field), f"opt.{field}")
    rho = state.rho
    if dp_mode == "admm":
        load(".duals", state.duals, "duals")
        rho = ckpt._load(get(".rho"), rho, ".rho")
    return state._replace(
        opt=state.opt._replace(count=int(np.asarray(get(".opt.count")))),
        step=int(np.asarray(get(".step"))), rho=rho)


def train_state_to(state: TrainState, device) -> TrainState:
    """A copy of a `TrainState` on `device`, through its checkpoint
    arrays (the same bits; a CPU state continued on the card and back)."""
    return train_state_from_arrays(
        state.params.cfg, ckpt._flatten(train_state_tree(state)),
        dp_mode="admm" if state.duals is not None else "allreduce",
        device=device)


def state_shardings(state: TrainState, cfg: ModelConfig, mesh, *,
                    dp_mode: str,
                    consensus_axis: Optional[str] = None) -> TrainState:
    """The specs of a state's tensors, leaf for leaf the reference's
    (`dist.sharding.param_shardings`): a consensus mode's replica axis
    leads (and the port's replica has no such dim: its entry is dropped),
    fsdp only without a replica axis, no fsdp on locally dispatched MoE
    experts, and the AdamW count, step and rho replicated (the empty
    spec).  `mesh` may be a `DeviceMesh` or a {name: size} mapping."""
    replica = consensus_axis if dp_mode != "allreduce" else None
    specs = lambda tree: _specs(adamw.named(tree), cfg, mesh,
                                replica_axis=replica)
    return TrainState(
        params=specs(state.params),
        opt=adamw.AdamState(mu=specs(state.opt.mu), nu=specs(state.opt.nu),
                            count=()),
        duals=specs(state.duals) if state.duals is not None else None,
        step=(), rho=() if state.rho is not None else None)


def _specs(named: dict, cfg: ModelConfig, mesh, *,
           replica_axis: Optional[str]) -> dict:
    """{name: spec} of a state's tree (the parameters, a moment, the
    duals: one spec a parameter name)."""
    return sharding.param_shardings(
        named, mesh, fsdp=cfg.fsdp and replica_axis is None,
        scanned=model_lib._homogeneous(cfg), replica_axis=replica_axis,
        no_fsdp_keys=("moe",) if cfg.moe_local_dispatch else ())


def batch_sharding(mesh) -> tuple:
    """The batch's placements on `mesh`: its rows over the dp axes
    (`dist.sharding.batch_spec`), replicated over the rest."""
    return sharding.placements(sharding.batch_spec(mesh), mesh)


def replica_mesh(mesh, axis: Optional[str]):
    """The sub-mesh one replica spans: `mesh` without its consensus axis
    (the whole mesh without one; None for a mesh of the consensus axis
    alone, whose replicas are plain tensors, one a rank)."""
    if axis is None:
        return mesh
    rest = tuple(a for a in mesh.mesh_dim_names if a != axis)
    return mesh[rest] if rest else None


# ---------------------------------------------------------------------------
# Step factories
# ---------------------------------------------------------------------------
def make_train_step(cfg: ModelConfig, mesh=None, *,
                    dp_mode: str = "allreduce",
                    consensus_axis: Optional[str] = None,
                    hyper: TrainHyper = TrainHyper(),
                    use_kernels: bool = False):
    """Returns a (state, batch) -> (state, metrics) function.  `batch` is
    the global batch ({"tokens": (B, S) ids, "frontend"?: (B,
    frontend_len, d)} on the state's device, the same on every rank).

    Without `mesh`: "allreduce" on this process alone.  With a
    `DeviceMesh`: "allreduce" data-parallel over its dp axes (the state
    laid out by `init_state(mesh=)`); "diffusion" / "admm" one replica
    per coordinate of `consensus_axis` (default "data"), each on its
    rows.  The metrics are plain tensors, equal on every rank of a
    replica.  `use_kernels=True` raises: the kernels have no backward."""
    if use_kernels:
        raise RuntimeError(
            "the kernels have no backward (nor have the JAX package's "
            "Pallas kernels): train on the plain path (use_kernels=False)")
    if dp_mode not in DP_MODES:
        raise ValueError(f"dp_mode must be one of {DP_MODES}: {dp_mode!r}")
    if dp_mode == "allreduce":
        return _allreduce_step(cfg, hyper, mesh)
    if mesh is None:
        raise ValueError(f"dp_mode={dp_mode!r} needs a device mesh (its "
                         f"consensus axis's coordinates are the replicas)")
    return _consensus_step(cfg, mesh, dp_mode, consensus_axis or "data",
                           hyper)


def _local_update(cfg, hyper, params, opt, batch, step):
    lr = schedules.cosine_warmup(step, peak_lr=hyper.peak_lr,
                                 warmup=hyper.warmup,
                                 total=hyper.total_steps)
    named = adamw.named(params)
    loss, aux = loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(loss, list(named.values()))
    # a DTensor gradient comes out of the backward as partial sums over
    # the ranks that saw other rows: its parameter's layout reduces it
    grads = {n: _like(g, p) for (n, p), g in zip(named.items(), grads)}
    grads, gnorm = adamw.clip_by_global_norm(grads, hyper.clip_norm)
    _, new_opt = adamw.update(grads, opt, named, lr=lr,
                              weight_decay=hyper.weight_decay)
    gnorm = sharding.full(gnorm)
    metrics = {"loss": sharding.full(loss).detach(),
               "ce": sharding.full(aux["ce"]).detach(),
               "grad_norm": gnorm,
               "lr": torch.tensor(float(lr), device=gnorm.device)}
    return new_opt, metrics


def _like(g, p):
    """Gradient `g` in the layout of its parameter `p`."""
    if isinstance(p, DTensor):
        return sharding.relayout(g, p.device_mesh, p.placements)
    return g


def _global_rows(batch: dict, mesh, rows: Optional[slice] = None) -> dict:
    """The global batch (every rank holding it whole) as DTensors with
    their rows over the dp axes of `mesh`; `rows` first takes a block
    (a replica's)."""
    out = {}
    for k, a in batch.items():
        a = a if rows is None else a[rows]
        out[k] = sharding.to_dtensor(a, mesh, sharding.placements_for(
            mesh, batch=a.shape[0]))
    return out


def _allreduce_step(cfg, hyper, mesh=None):
    def step_fn(state: TrainState, batch):
        if mesh is None:
            new_opt, metrics = _local_update(cfg, hyper, state.params,
                                             state.opt, batch, state.step)
        else:
            with sharding.use_mesh(mesh):
                new_opt, metrics = _local_update(
                    cfg, hyper, state.params, state.opt,
                    _global_rows(batch, mesh), state.step)
        return TrainState(state.params, new_opt, None, state.step + 1), \
            metrics

    return step_fn


def _stacked_leaf(name: str) -> str:
    """The reference's leaf of a layer's parameter in a stacked
    (homogeneous) stack: blocks.3.attn.wq -> blocks.attn.wq."""
    parts = name.split(".")
    return ".".join(parts[:1] + parts[2:]) if parts[0] == "blocks" else name


def _consensus_step(cfg, mesh, dp_mode: str, axis: str, hyper):
    is_admm = dp_mode == "admm"
    leaf_of = _stacked_leaf if model_lib._homogeneous(cfg) else None
    ex = collectives.axis_executor(mesh, axis)
    sub = replica_mesh(mesh, axis)
    n_rep = sharding.axis_size(mesh, axis)
    me = mesh.get_local_rank(axis)

    def step_fn(state: TrainState, batch):
        named = adamw.named(state.params)
        prev = ({n: p.detach().clone() for n, p in named.items()}
                if is_admm else None)
        B = next(iter(batch.values())).shape[0]
        if B % n_rep:
            raise ValueError(f"a batch of {B} rows does not split over "
                             f"{n_rep} replicas")
        rows = slice(me * (B // n_rep), (me + 1) * (B // n_rep))
        # local stochastic step on local data (no consensus-axis psum)
        if sub is None:
            new_opt, metrics = _local_update(
                cfg, hyper, state.params, state.opt,
                {k: a[rows] for k, a in batch.items()}, state.step)
        else:
            with sharding.use_mesh(sub):
                new_opt, metrics = _local_update(
                    cfg, hyper, state.params, state.opt,
                    _global_rows(batch, sub, rows), state.step)
        zero = torch.zeros((), dtype=torch.float32,
                           device=metrics["loss"].device)
        if not is_admm:
            consensus.diffusion_combine(named, ex, hyper.w_self)
            duals, rho_new = None, state.rho
            r_norm = s_norm = zero
        else:
            kap = float(schedules.kappa(np.float32(state.step)
                                        + np.float32(1.0), hyper.xi))
            # the residual norms ride along on the dual update's exchange
            _, duals, (r_norm, s_norm) = consensus.admm_step(
                named, prev, state.duals, ex, rho=state.rho, kappa=kap,
                return_residuals=True)
            del prev
            rho_new = (consensus.adapt_rho(state.rho, r_norm, s_norm,
                                           mu=hyper.rho_mu)
                       if hyper.adaptive_rho else state.rho)
        local = torch.stack([metrics[k].float()
                             for k in ("loss", "ce", "grad_norm", "lr")])
        metrics = dict(zip(("loss", "ce", "grad_norm", "lr"),
                           collectives.pmean(local, ex).unbind()))
        metrics["consensus_residual"] = consensus.consensus_residual(
            named, ex, leaf_of)
        metrics["admm_primal_resid"] = r_norm
        metrics["admm_dual_resid"] = s_norm
        metrics["admm_rho"] = rho_new if is_admm else zero
        return TrainState(state.params, new_opt, duals, state.step + 1,
                          rho_new), metrics

    return step_fn


def batch_to(batch: dict, device, rows: Optional[slice] = None) -> dict:
    """A host batch (`data.tokens.Batcher`) on `device`: tokens as int64,
    the frontend stub as float32; `rows` takes this rank's rows."""
    dev = resolve(device)
    out = {}
    for k, a in batch.items():
        a = a if rows is None else a[rows]
        out[k] = torch.as_tensor(
            a, dtype=torch.int64 if k == "tokens" else torch.float32,
            device=dev)
    return out
