"""Unified conjugate-exponential VB engine: Model x Topology.

Port of `repro.core.engine`, with both executors.  Every estimator
of the paper is the same per-iteration kernel — each node runs a VBE step
+ local VBM optimum to get phi*_i (Eq. 18) — followed by a topology rule
that turns the stack {phi*_i} into the next iterate:

* Eq. 20   fusion-centre average                `FusionCenter.combine`
* Eq. 22/29 Robbins-Monro step size eta_t       `eta_schedule` / `Schedule`
* Eq. 27a  natural-gradient step                `_CombineTopology.step`
* Eq. 27b  diffusion combine                    `Diffusion.combine` /
                                                `RingDiffusion.combine`
* Eq. 38a  ADMM primal update                   `ADMMConsensus.step`
* Eq. 38b  projection onto Omega                `ADMMConsensus.step`
* Eq. 39   ADMM dual ascent                     `ADMMConsensus.step`
* Eq. 40   kappa_t dual-step ramp               `kappa_schedule`
* Eq. 46   KL performance metric                `kl_to_reference`

Every graph topology runs dense (an (N, N) matrix: the small-N parity
oracle) or sparse (`network.SparseGraph` edge lists through
`_sparse_combine`: O(E + N), 100,000 sensors on one card), and two
scenario topologies build on the sparse layer: `PairwiseGossip`
(randomized link activation, deterministic in (seed, absolute t)) and
`HierarchicalFusion` (sensor -> gateway -> region).  The sparse
neighbour reduce is `_segment_sum`: a segmented sum over the
receiver-sorted edges (`torch.segment_reduce` with the per-node
lengths), deterministic, with no float atomics and no host sync.

Sessions: `vb_init` returns a `VBState` (phi, absolute iteration t, the
topology carry — the ADMM duals —, the minibatch stream and the last
diagnostics); `vb_run` advances it with a Python step loop (the
reference's `lax.scan`).  Every per-iteration quantity is a function of
the absolute t, so `vb_run(s, a + b)` equals `vb_run(vb_run(s, a)[0], b)`
bit for bit, and a state saved with `checkpoint.ckpt.save` resumes
exactly.  `run_vb` is the one-shot wrapper.  `session_step_fn` is the
one-iteration kernel over raw state with the data as an argument, and
`hyper_names` / `session_hyper` the per-session constants (tau, d0,
rho, xi) it can take as a `hyper` dict instead of the built-in ones.
`fleet_step_fn` is the same iteration over a serving fleet: S sessions
along a leading slot axis, each at its own device-side t, one local step
for the whole fleet (serving/driver.py).

Streaming (`minibatch=data.stream.MinibatchSpec(...)`): each iteration
gathers a per-node minibatch with a scaled mask (data/stream.py) from the
session's streamed copy of the data, so phi* is the stochastic estimate
Algorithm 1's Robbins-Monro step assumes; `control_variate="svrg"` adds
the full-batch anchor of `_iteration`.

Time-varying networks: `Diffusion`, `RingDiffusion` and `ADMMConsensus`
take `link_drop` / `link_mask_fn` (`_LinkSchedule`); the coins are a
counter-based hash of (link_seed, t) (`network.link_generator`), the same
bits on the CPU and on the card.  `ADMMConsensus` carries the
reference's adaptive-penalty subsystem (residual balancing, per-block
penalties, dual warmup, dual reset), written as tensor ops with no host
sync in the step.

The node axis is a plain tensor axis throughout (no Python loop over
nodes).  `executor=MeshExecutor(group)` (repro_torch.dist) splits it over
the ranks of a `torch.distributed` group, SPMD: every rank calls `run_vb`
/ `vb_run` with the same global inputs, works on its contiguous block of
rows (`_run_vb_sharded`), and each topology's combine becomes its
collective (the reference's `axis` branches): an all-gather and the
local rows for an arbitrary graph, the ring's two boundary exchanges,
`pmean` for the fusion centre, `psum` for ADMM's norms and counters.
The final state and the (T, N) KLs are gathered, so every rank returns
the complete `VBRun` / `VBState`; a one-rank group gives the single-array
executor's bits.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch import telemetry
from repro_torch.core import network as network_lib
from repro_torch.data import stream as stream_lib
from repro_torch.dist import collectives, sharding
from repro_torch.dist.collectives import (  # noqa: F401  (the reference's)
    MeshExecutor, _ring_perms, ring_combine, ring_combine_block,
    ring_neighbors,
)
from repro_torch.telemetry import taps


# ---------------------------------------------------------------------------
# Step-size schedules (Eqs. 29 and 40)
# ---------------------------------------------------------------------------
def eta_schedule(t, tau: float, d0: float = 1.0):
    """eta_t = 1 / (d0 + tau * t); satisfies Robbins-Monro (Eq. 22).

    >>> [round(eta_schedule(t, tau=0.5), 3) for t in (1.0, 2.0, 10.0)]
    [0.667, 0.5, 0.167]
    """
    return 1.0 / (d0 + tau * t)


def kappa_schedule(t, xi: float = 0.05):
    """kappa_t = 1 - 1/(1 + xi t)^2 ramps the ADMM dual step (Eq. 40).

    >>> kappa_schedule(1.0) < 0.15, kappa_schedule(99.0) > 0.95
    (True, True)
    """
    return 1.0 - 1.0 / (1.0 + xi * t) ** 2


class Schedule(NamedTuple):
    """eta_t of the natural-gradient step (27a).  `eta_fixed=1.0` is the
    one-shot estimators (cVB / noncoop / nsg-dVB), `None` the paper's
    Robbins-Monro schedule.

    >>> round(Schedule(tau=0.2).eta(0), 4), ONE_SHOT.eta(0)
    (0.8333, 1.0)
    """

    tau: float = 0.2
    d0: float = 1.0
    eta_fixed: Optional[float] = None

    def eta(self, t, hyper=None):
        """eta_t.  `hyper` (see `hyper_names`) may override `tau` / `d0`
        with per-session values; None keeps the built-in constants.  A
        serving fleet's t is an (S,) int64 tensor (and its hyper (S,)
        tensors): eta_t is then (S,) in float64, the same IEEE operations
        as the Python float of an int t."""
        if self.eta_fixed is not None:
            return float(self.eta_fixed)
        tau = self.tau if not hyper or "tau" not in hyper else hyper["tau"]
        d0 = self.d0 if not hyper or "d0" not in hyper else hyper["d0"]
        return eta_schedule(_float_t(t) + 1.0, tau, d0)


ONE_SHOT = Schedule(eta_fixed=1.0)


def _float_t(t):
    """An iteration index as a float: a Python float of an int, float64
    of a fleet's (S,) int64 tensor (never the default f32 that `t + 1.0`
    would give an int tensor)."""
    return t.to(torch.float64) if isinstance(t, torch.Tensor) else float(t)


def _per_slot(v, like: torch.Tensor):
    """A per-session factor against a (..., N, P) operand: a Python
    number or a 0-dim tensor as it is; a fleet's (S,) tensor in `like`'s
    dtype, viewed (S, 1, 1) (the same rounding as the scalar a solo
    session multiplies by)."""
    if isinstance(v, torch.Tensor) and v.dim() >= 1:
        return v.to(like.dtype).reshape(v.shape + (1, 1))
    return v


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    # a read-only array (e.g. a view of another package's buffer) cannot
    # back a tensor: copy it
    return torch.as_tensor(a if a.flags.writeable else a.copy())


# ---------------------------------------------------------------------------
# Residual balancing (Boyd et al. Sec. 3.4.1)
# ---------------------------------------------------------------------------
def residual_balanced_rho(rho, r_norm, s_norm, *, mu: float = 10.0,
                          tau_incr: float = 2.0, tau_decr: float = 2.0,
                          rho_min: float = 1e-3, rho_max: float = 1e3):
    """One residual-balancing update of the ADMM penalty: grow rho by
    `tau_incr` where the primal residual dominates (||r|| > mu ||s||),
    shrink it by `tau_decr` where the dual residual dominates
    (||s|| > mu ||r||), else keep it; clip to [rho_min, rho_max].  Shapes
    broadcast (rho may be a scalar or a per-block vector); tensor ops
    only, so no host sync.

    >>> one = torch.tensor(1.0)
    >>> [float(residual_balanced_rho(one, torch.tensor(r), torch.tensor(s)))
    ...  for r, s in ((100.0, 1.0), (1.0, 100.0), (1.0, 2.0))]
    [2.0, 0.5, 1.0]
    """
    rho = _as_tensor(rho)
    r_norm = torch.as_tensor(r_norm, dtype=rho.dtype, device=rho.device)
    s_norm = torch.as_tensor(s_norm, dtype=rho.dtype, device=rho.device)
    grow = r_norm > mu * s_norm
    shrink = s_norm > mu * r_norm
    fac = torch.where(grow, torch.full_like(r_norm, tau_incr),
                      torch.where(shrink,
                                  torch.full_like(r_norm, 1.0 / tau_decr),
                                  torch.ones_like(r_norm)))
    return torch.clamp(rho * fac, rho_min, rho_max)


# ---------------------------------------------------------------------------
# Time-varying links (failing sensor links, Sec. II's unreliable networks)
# ---------------------------------------------------------------------------
def _given_masks(fn, t, dtype, device) -> torch.Tensor:
    """A parity hook's mask of iteration t on `device`.  For a serving
    fleet's (S,) t the hook is called once per slot with that slot's t,
    read on the host: the one device sync a fleet iteration makes, and
    only when a hook is given (the port's own coins need none)."""
    if isinstance(t, torch.Tensor):
        return torch.stack([_given_masks(fn, ti, dtype, device)
                            for ti in t.tolist()])
    return _as_tensor(fn(t)).to(device=device, dtype=dtype)


class _LinkSchedule:
    """Per-iteration link-failure schedule shared by the topologies.

    Two forms, mutually exclusive:

    * `link_drop` — every undirected link independently fails with this
      probability each iteration, the coins drawn on the run's device from
      `network.link_generator(link_seed, t)` (`network.link_keep_matrix`,
      `network.ring_link_keep`): a split run replays them, and a CPU run
      draws the same ones as a card run.
    * `link_mask_fn(t)` — an explicit keep-mask sequence: the iteration-t
      keep mask, (N, N) 0/1 symmetric for graph topologies, (N,) per ring
      edge for `RingDiffusion` (a tensor or an array; it is moved to the
      run's device).

    With neither set the topology is static and takes the time-invariant
    code path unchanged.  A serving fleet passes t as an (S,) tensor, one
    iteration per slot: the masks take a leading (S,) axis.
    """

    def __init__(self, link_drop: float = 0.0, link_seed: int = 0,
                 link_mask_fn=None):
        if link_drop and link_mask_fn is not None:
            raise ValueError("pass link_drop OR link_mask_fn, not both")
        if not 0.0 <= link_drop <= 1.0:
            raise ValueError(f"link_drop must be a probability: {link_drop}")
        self.link_drop = float(link_drop)
        self.link_seed = int(link_seed)
        self.link_mask_fn = link_mask_fn
        self.time_varying = bool(link_drop) or link_mask_fn is not None

    @staticmethod
    def _require_t(t):
        if t is None:
            raise ValueError(
                "time-varying links need the iteration index: call "
                "combine(..., t=<iteration>) (run_vb supplies it)")
        return t if isinstance(t, torch.Tensor) else int(t)

    def _given(self, t, dtype, device):
        return _given_masks(self.link_mask_fn, t, dtype, device)

    def keep_matrix(self, t, n: int, dtype, device) -> torch.Tensor:
        t = self._require_t(t)
        if self.link_mask_fn is not None:
            return self._given(t, dtype, device)
        return network_lib.link_keep_matrix(
            network_lib.link_generator(self.link_seed, t, device), n,
            self.link_drop, dtype)

    def keep_ring(self, t, n: int, dtype, device) -> torch.Tensor:
        t = self._require_t(t)
        if self.link_mask_fn is not None:
            return self._given(t, dtype, device)
        return network_lib.ring_link_keep(
            network_lib.link_generator(self.link_seed, t, device), n,
            self.link_drop, dtype)

    def keep_edges(self, t, n_undirected: int, dtype,
                   device) -> torch.Tensor:
        """Edge-list form: the (E_undirected,) keep mask, one coin per
        undirected link (`network.sparse_link_keep`), so a failed link is
        failed both ways.  A `link_mask_fn` returns that mask in the
        graph's link order."""
        t = self._require_t(t)
        if self.link_mask_fn is not None:
            return self._given(t, dtype, device)
        return network_lib.sparse_link_keep(
            network_lib.link_generator(self.link_seed, t, device),
            n_undirected, self.link_drop, dtype)


def _dense_apply(M: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """M @ z for a (..., N, N) matrix and a (..., N, P) stack.  A serving
    fleet's (S, N, P) stack is multiplied slot by slot, each product the
    one a solo session makes: cuBLAS picks its algorithm by shape, and on
    the H100 no batched form (`bmm`, the folded `matmul`, `einsum`, one
    wide GEMM) rounds like the solo (N, N) @ (N, P) product for S > 1,
    a last-ulp difference the GMM iteration grows to ~2e-9 relative over
    200 iterations at 1000 sensors x 4096 points (PERF.md's serving
    entry).  S launches of an O(N^2 P) product beside a fleet iteration's
    ~180 kernels."""
    if z.dim() == 2:
        return M @ z
    return torch.stack([(M if M.dim() == 2 else M[s]) @ z[s]
                        for s in range(z.shape[0])])


def _gathered(z: torch.Tensor, axis) -> torch.Tensor:
    """The whole node axis -2 of a stack: z itself on the single-array
    executor, every rank's rows (an all-gather) under the mesh executor
    (`axis`)."""
    return z if axis is None else collectives.all_gather(z, axis, -2)


def _own_rows(full: torch.Tensor, n_local: int, axis,
              dim: int = -2) -> torch.Tensor:
    """This rank's `n_local` rows along `dim` of a whole-network array
    (all of it on the single-array executor)."""
    return full if axis is None \
        else collectives.local_rows(full, n_local, axis, dim)


def _segment_sum(x: torch.Tensor, lengths: torch.Tensor,
                 axis: int = 0) -> torch.Tensor:
    """Sums of consecutive segments of x along `axis`, of the given
    lengths: the sparse reduce (a `SparseGraph`'s receiver-sorted edges
    with the lengths `deg`; a hierarchy's sorted members).  Each segment
    is added in order by one thread (no float atomics, unlike
    `index_add_` on CUDA), so two launches on the same inputs agree bit
    for bit, a fleet's slots (leading axes) are reduced each on its own
    exactly as a solo session, and `unsafe=True` skips the length check
    that would wait for the device."""
    axis = axis % x.dim()
    if axis:
        lengths = lengths.expand(x.shape[:axis] + lengths.shape)
    return torch.segment_reduce(x, "sum", lengths=lengths, axis=axis,
                                unsafe=True)


def _sparse_combine(graph, w_edge, w_self, varphi: torch.Tensor,
                    keep_und: Optional[torch.Tensor] = None):
    """Eq. 27b in edge-list form: phi_i <- w_self_i varphi_i
    + sum_{e: recv(e)=i} w_e varphi_send(e), one segmented sum over the
    directed edges: O(E P) work, O(N P + E P) memory, no (N, N) matrix.
    varphi is (..., N, P): a serving fleet's slots lead, each combined
    over its own nodes.

    `keep_und` ((..., E_undirected)) gates the undirected links of a
    time-varying network: the surviving weights renormalise per receiver
    (for Eq. 47 weights that is Eq. 47 on the surviving graph, the dense
    `_effective_weights`), and a node with no live link and zero
    self-weight keeps its iterate.
    """
    w_e = w_edge.to(varphi.dtype)
    w_s = w_self.to(varphi.dtype)
    msg = varphi.index_select(-2, graph.senders)         # (..., E, P)
    if keep_und is None:
        return w_s[:, None] * varphi + _segment_sum(
            w_e[:, None] * msg, graph.deg, -2)
    w_e = w_e * keep_und.index_select(-1, graph.edge_id).to(varphi.dtype)
    num = w_s[:, None] * varphi + _segment_sum(w_e[..., None] * msg,
                                               graph.deg, -2)
    den = w_s + _segment_sum(w_e, graph.deg, -1)
    isolated = den <= 0.0
    safe = torch.where(isolated, torch.ones_like(den), den)
    return torch.where(isolated[..., None], varphi, num / safe[..., None])


# ---------------------------------------------------------------------------
# Topologies / combiners
# ---------------------------------------------------------------------------
class _CombineTopology:
    """Topologies of the form: (27a) varphi_i = phi_i + eta (phi*_i - phi_i),
    then a linear combine of {varphi_i}.  `step` returns
    (phi_next, carry_next, diag); diag is None for combine topologies.

    Every combine reduces over the node axis -2 of a (..., N, P) stack: a
    solo session's (N, P), or a serving fleet's (S, N, P) with t an (S,)
    tensor, where each slot is combined over its own nodes only.

    Under the mesh executor `axis` is the `MeshExecutor`, the stack holds
    this rank's block of rows, and `local` the rank's rows of the
    topology's `shard_inputs` (the reference's shard_map branches)."""

    uses_schedule = True
    emits_diagnostics = False
    #: the type's fleet step launches nothing that waits for the host (no
    #: `.item()`, `.tolist()` or error flag read back), so a serving fleet
    #: may replay it as a CUDA graph (serving/driver.py); False keeps the
    #: fleet on its eager loop
    sync_free_step = False

    def sync_free(self) -> bool:
        """`sync_free_step`, unless this instance has a parity hook
        (`link_mask_fn`, `active_mask_fn`): `_given_masks` reads each
        slot's t on the host with `t.tolist()`."""
        links = getattr(self, "links", None)
        hooked = ((links is not None and links.link_mask_fn is not None)
                  or getattr(self, "active_mask_fn", None) is not None)
        return self.sync_free_step and not hooked

    def to(self, device) -> "_CombineTopology":
        """Copy with every tensor and `SparseGraph` attribute on `device`
        (the weights, the edge lists, the hierarchy's index maps)."""
        new = copy.copy(self)
        for name, val in vars(self).items():
            if isinstance(val, (torch.Tensor, network_lib.SparseGraph)):
                setattr(new, name, val.to(device))
        return new

    def shard_inputs(self) -> dict:
        """Per-node arrays the mesh executor shards along the node axis
        (the rows of a dense weight or adjacency matrix)."""
        return {}

    def init_carry(self, phi0: torch.Tensor, model=None):
        return None

    def carry_specs(self):
        """The carry's spec under the mesh executor (dist/sharding.py):
        per-node leaves shard their node axis."""
        return sharding.NODE

    def init_diag(self, model, phi0: torch.Tensor):
        return None

    def combine(self, varphi: torch.Tensor, *, axis=None, local=None,
                t=None) -> torch.Tensor:
        raise NotImplementedError

    def step(self, model, phi, carry, phi_star, t: int, schedule: Schedule,
             hyper=None, *, axis=None, local=None, diagnostics=True):
        if schedule.eta_fixed == 1.0:
            varphi = phi_star                       # one-shot: jump to phi*
        else:                                       # Eq. 27a
            varphi = phi + _per_slot(schedule.eta(t, hyper), phi) * (
                phi_star - phi)
        return (self.combine(varphi, axis=axis, local=local, t=t), carry,
                None)


class FusionCenter(_CombineTopology):
    """Centralised reference: phi <- mean_i phi*_i exactly (Eq. 20).

    >>> FusionCenter().combine(torch.tensor([[0.0, 2.0], [2.0, 4.0]])
    ...                        ).tolist()
    [[1.0, 3.0], [1.0, 3.0]]
    """

    sync_free_step = True

    def combine(self, varphi, *, axis=None, local=None, t=None):
        mean = varphi.mean(-2, keepdim=True)
        if axis is not None:
            mean = collectives.pmean(mean, axis)
        return mean.expand_as(varphi)


class Isolated(_CombineTopology):
    """No communication (noncoop-VB): every node keeps its own iterate."""

    sync_free_step = True

    def combine(self, varphi, *, axis=None, local=None, t=None):
        return varphi


class Diffusion(_CombineTopology):
    """Diffusion combine phi_i <- sum_j w_ij varphi_j (Eq. 27b) with a
    row-stochastic weight matrix (e.g. Eq. 47): EITHER the dense (N, N)
    matrix (the small-N oracle) OR a `network.SparseWeights` edge-list
    bundle (`sparse_nearest_neighbor_weights` /
    `sparse_metropolis_weights`), which runs the same combine as a
    segmented sum over the edges (`_sparse_combine`).

    `link_drop` / `link_mask_fn` make the network time-varying: each
    iteration the surviving entries are renormalised per row (for Eq. 47
    weights that is Eq. 47 on the surviving graph), so the combine stays
    row-stochastic over whatever links are up.  In sparse form a
    `link_mask_fn` returns the (E_undirected,) per-link keep mask.

    >>> W = torch.tensor([[0.5, 0.5], [0.5, 0.5]])
    >>> Diffusion(W).combine(torch.tensor([[0.0], [4.0]])).tolist()
    [[2.0], [2.0]]
    >>> dead = Diffusion(W, link_mask_fn=lambda t: torch.eye(2))
    >>> dead.combine(torch.tensor([[0.0], [4.0]]), t=0).tolist()
    [[0.0], [4.0]]
    """

    sync_free_step = True

    def __init__(self, weights, *, link_drop: float = 0.0,
                 link_seed: int = 0, link_mask_fn=None):
        self.sparse = isinstance(weights, network_lib.SparseWeights)
        if self.sparse:
            # the host f64 weights, and their tensors (moved by `to`)
            self.graph = weights.graph
            self.w_edge = torch.from_numpy(np.asarray(weights.w_edge,
                                                      np.float64))
            self.w_self = torch.from_numpy(np.asarray(weights.w_self,
                                                      np.float64))
        self.weights = weights if self.sparse else _as_tensor(weights)
        self.links = _LinkSchedule(link_drop, link_seed, link_mask_fn)

    def shard_inputs(self) -> dict:
        # sparse: the edge arrays are not per-node rows; the combine
        # gathers the node axis and keeps its local rows
        return {} if self.sparse else {"weights": self.weights}

    def _effective_weights(self, W, t, *, axis=None):
        """Iteration t's weights (W: this rank's rows under the
        executor): drop-masked, row-renormalised.  A node never loses
        itself (the keep diagonal is forced to 1), so a row whose links
        are all down becomes the identity combine."""
        n = W.shape[-1]
        keep = self.links.keep_matrix(t, n, W.dtype, W.device)
        keep = torch.maximum(keep, torch.eye(n, dtype=W.dtype,
                                             device=W.device))
        W_eff = W * _own_rows(keep, W.shape[-2], axis)    # (..., N, N)
        rows = W_eff.sum(-1, keepdim=True)
        return W_eff / torch.where(rows > 0, rows, torch.ones_like(rows))

    def combine(self, varphi, *, axis=None, local=None, t=None):
        if self.sparse:
            keep = (self.links.keep_edges(t, self.graph.n_undirected,
                                          varphi.dtype, varphi.device)
                    if self.links.time_varying else None)
            # every node must see the messages addressed to it: under
            # the executor gather the node axis, combine over the edge
            # list, keep the local rows
            return _own_rows(_sparse_combine(
                self.graph, self.w_edge, self.w_self,
                _gathered(varphi, axis), keep), varphi.shape[-2], axis)
        W = (self.weights if axis is None else local["weights"]).to(
            varphi.dtype)
        if self.links.time_varying:
            W = self._effective_weights(W, t, axis=axis)
        # an arbitrary graph's combine on the executor: all-gather, then
        # this rank's rows of W
        return _dense_apply(W, _gathered(varphi, axis))


class RingDiffusion(_CombineTopology):
    """Diffusion on the cycle graph: each node keeps `w_self` and takes
    (1 - w_self) / 2 from each ring neighbour (Eq. 47 on a cycle at
    w_self = 1/3), as two `torch.roll`s and a weighted sum.

    >>> varphi = torch.tensor([[4.0], [8.0], [12.0]])
    >>> RingDiffusion(w_self=0.5).combine(varphi).tolist()
    [[7.0], [8.0], [9.0]]

    Under `link_drop` / `link_mask_fn` (an (N,) mask, entry i gating the
    link (i, i+1 mod N)) the weights renormalise over the surviving links;
    a node with both links down and w_self = 0 keeps its iterate.

    `graph=network.SparseGraph.ring(N)` runs the same combine through the
    edge-list segmented sum.  `SparseGraph.ring` orders link k as
    (k, k+1 mod N), the coin order of `ring_link_keep`, so the sparse path
    replays the same link failures as the roll-based one.
    """

    sync_free_step = True

    def __init__(self, w_self: float = 1.0 / 3.0, *, link_drop: float = 0.0,
                 link_seed: int = 0, link_mask_fn=None, graph=None):
        self.w_self = w_self
        self.links = _LinkSchedule(link_drop, link_seed, link_mask_fn)
        self.graph = graph
        if graph is not None:
            ring = network_lib.SparseGraph.ring(graph.n_nodes)
            for name in ("senders", "receivers", "edge_id"):
                if not torch.equal(getattr(graph, name).cpu(),
                                   getattr(ring, name)):
                    raise ValueError(
                        "RingDiffusion(graph=) must be SparseGraph.ring(N) "
                        "(link k = (k, k+1 mod N), the ring_link_keep "
                        "coin order)")
            w_n = (1.0 - w_self) / 2.0
            self.w_edge = torch.full((2 * graph.n_undirected,), w_n,
                                     dtype=torch.float64)
            self.w_self_nodes = torch.full((graph.n_nodes,), w_self,
                                           dtype=torch.float64)

    def _gated(self, varphi, left, right, e_left, e_right):
        """The combine over the surviving ring links only, renormalised
        (row-stochastic every iteration)."""
        w_n = (1.0 - self.w_self) / 2.0
        num = (self.w_self * varphi
               + w_n * (e_left[..., None] * left
                        + e_right[..., None] * right))
        den = self.w_self + w_n * (e_left + e_right)
        isolated = den <= 0.0
        safe = torch.where(isolated, torch.ones_like(den), den)
        return torch.where(isolated[..., None], varphi,
                           num / safe[..., None])

    def combine(self, varphi, *, axis=None, local=None, t=None):
        if self.graph is not None:
            # the edge-list path: a ring's (E_und,) link masks are the
            # (N,) ring_link_keep masks (same order)
            keep = (self.links.keep_edges(t, self.graph.n_undirected,
                                          varphi.dtype, varphi.device)
                    if self.links.time_varying else None)
            return _own_rows(_sparse_combine(
                self.graph, self.w_edge, self.w_self_nodes,
                _gathered(varphi, axis), keep), varphi.shape[-2], axis)
        n_local = varphi.shape[-2]
        if axis is None:
            left = torch.roll(varphi, 1, dims=-2)        # phi_{i-1}
            right = torch.roll(varphi, -1, dims=-2)      # phi_{i+1}
        else:       # the ring's blocks: only boundary rows cross ranks
            left, right = collectives.ring_boundaries(varphi, axis)
        if not self.links.time_varying:
            w_n = (1.0 - self.w_self) / 2.0
            return self.w_self * varphi + w_n * (left + right)
        n = n_local if axis is None \
            else n_local * collectives.axis_size(axis)
        e = self.links.keep_ring(t, n, varphi.dtype, varphi.device)
        # node i's links (i-1, i) and (i, i+1)
        return self._gated(varphi, left, right,
                           _own_rows(torch.roll(e, 1, dims=-1), n_local,
                                     axis, -1),
                           _own_rows(e, n_local, axis, -1))


class PairwiseGossip(_CombineTopology):
    """Randomized gossip (Boyd-Ghosh-Prabhakar-Shah style) on a
    `SparseGraph`: each iteration every undirected link activates with
    probability `p_activate`, deterministic in (`seed`, absolute t) (coin
    k of `network.link_generator(seed, t)`, the same bits on the CPU and
    on the card), and each node averages with Eq. 47 weights over its
    ACTIVE neighbourhood:

        phi_i <- (varphi_i + sum_{active links (i,j)} varphi_j)
                 / (1 + |N_i^active(t)|)

    A node with no active link keeps its iterate.  `p_activate=1.0` is
    dense `Diffusion` with `nearest_neighbor_weights` on the same graph.

    `active_mask_fn(t)`, a parity hook like `link_mask_fn`: given, it
    returns iteration t's (E_undirected,) activation mask in the graph's
    link order instead of the port's coins (the reference's
    `jax.random` activations, which torch cannot reproduce, in the parity
    tests).

    >>> g = network_lib.SparseGraph.ring(3)
    >>> PairwiseGossip(g, p_activate=1.0).combine(
    ...     torch.tensor([[3.0], [6.0], [9.0]]), t=0).tolist()
    [[6.0], [6.0], [6.0]]
    """

    sync_free_step = True

    def __init__(self, graph, *, p_activate: float = 0.5, seed: int = 0,
                 active_mask_fn=None):
        if not 0.0 < p_activate <= 1.0:
            raise ValueError(f"p_activate must be in (0, 1]: {p_activate}")
        if not isinstance(graph, network_lib.SparseGraph):
            raise ValueError("PairwiseGossip needs a network.SparseGraph "
                             "(use SparseGraph.from_dense for small "
                             "adjacency matrices)")
        self.graph = graph
        self.p_activate = float(p_activate)
        self.seed = int(seed)
        self.active_mask_fn = active_mask_fn

    def active(self, t, dtype, device) -> torch.Tensor:
        """Iteration t's (E_undirected,) activation mask ((S, E_und) for
        a fleet's (S,) t)."""
        if self.active_mask_fn is not None:
            return _given_masks(self.active_mask_fn, t, dtype, device)
        # active with probability p_activate: kept at drop 1 - p
        return network_lib.sparse_link_keep(
            network_lib.link_generator(self.seed, t, device),
            self.graph.n_undirected, 1.0 - self.p_activate, dtype)

    def combine(self, varphi, *, axis=None, local=None, t=None):
        if t is None:
            raise ValueError(
                "PairwiseGossip draws its activation from the iteration "
                "index: call combine(..., t=<iteration>) (run_vb supplies "
                "it)")
        g = self.graph
        if not isinstance(t, torch.Tensor):
            t = int(t)
        act = self.active(t, varphi.dtype, varphi.device)
        act_dir = act.index_select(-1, g.edge_id)
        full = _gathered(varphi, axis)
        num = full + _segment_sum(
            act_dir[..., None] * full.index_select(-2, g.senders), g.deg,
            -2)
        den = 1.0 + _segment_sum(act_dir, g.deg, -1)  # 1 + |N_i^active|
        out = num / den[..., None]
        return _own_rows(out, varphi.shape[-2], axis)


class HierarchicalFusion(_CombineTopology):
    """Two-level sensor -> gateway -> region fusion: each gateway averages
    its sensors' iterates, each region its gateways' means, and every
    sensor blends its own iterate with its gateway's and region's means:

        gw_g  = mean_{i: gateway(i)=g} varphi_i
        rg_r  = mean_{g: region(g)=r} gw_g
        phi_i <- w_self varphi_i + w_gateway gw_{gateway(i)}
                 + (1 - w_self - w_gateway) rg_{region(gateway(i))}

    Row-stochastic, O(N + G + R) memory, two segmented sums: the maps may
    come unsorted, so a stable sort of each (and the lengths) is made
    once, at construction.  One region with w_self = w_gateway = 0 is
    `FusionCenter`.  `network.two_level_partition` builds balanced maps.

    >>> gw, rg = network_lib.two_level_partition(4, 2, 1)
    >>> h = HierarchicalFusion(gw, rg, w_self=0.0, w_gateway=0.0)
    >>> h.combine(torch.tensor([[0.0], [2.0], [4.0], [6.0]])).tolist()
    [[3.0], [3.0], [3.0], [3.0]]
    """

    sync_free_step = True

    def __init__(self, gateway_of, region_of, *, w_self: float = 1.0 / 3.0,
                 w_gateway: float = 1.0 / 3.0):
        gw = np.asarray(_as_tensor(gateway_of).cpu(), np.int64)
        rg = np.asarray(_as_tensor(region_of).cpu(), np.int64)
        if gw.ndim != 1 or rg.ndim != 1:
            raise ValueError("gateway_of/region_of must be 1-D index maps")
        n_gateways = int(rg.shape[0])
        if gw.min(initial=0) < 0 or (gw.size and gw.max() >= n_gateways):
            raise ValueError("gateway_of must index into region_of")
        n_regions = int(rg.max()) + 1 if rg.size else 0
        if rg.min(initial=0) < 0:
            raise ValueError("region ids must be >= 0")
        gw_count = np.bincount(gw, minlength=n_gateways)
        rg_count = np.bincount(rg, minlength=n_regions)
        if (gw_count == 0).any() or (rg_count == 0).any():
            raise ValueError("every gateway needs >= 1 sensor and every "
                             "region >= 1 gateway")
        w_region = 1.0 - w_self - w_gateway
        if w_self < 0 or w_gateway < 0 or w_region < -1e-12:
            raise ValueError(
                f"weights must be a convex combination: w_self={w_self}, "
                f"w_gateway={w_gateway}, w_region={w_region}")
        self.gateway_of = torch.from_numpy(gw)
        self.region_of = torch.from_numpy(rg)
        self.n_gateways = n_gateways
        self.n_regions = n_regions
        # the segmented sums' inputs: the members sorted by segment (in
        # map order within one) and the lengths
        self.gw_order = torch.from_numpy(np.argsort(gw, kind="stable"))
        self.rg_order = torch.from_numpy(np.argsort(rg, kind="stable"))
        self.gw_count = torch.from_numpy(gw_count)
        self.rg_count = torch.from_numpy(rg_count)
        self.region_of_node = torch.from_numpy(rg[gw])
        self.w_self = float(w_self)
        self.w_gateway = float(w_gateway)
        self.w_region = float(max(w_region, 0.0))

    @staticmethod
    def _segment_mean(x, order, count):
        return (_segment_sum(x.index_select(-2, order), count, -2)
                / count.to(x.dtype)[:, None])

    def combine(self, varphi, *, axis=None, local=None, t=None):
        full = _gathered(varphi, axis)
        gw_mean = self._segment_mean(full, self.gw_order, self.gw_count)
        rg_mean = self._segment_mean(gw_mean, self.rg_order, self.rg_count)
        out = (self.w_self * full
               + self.w_gateway * gw_mean.index_select(-2, self.gateway_of)
               + self.w_region * rg_mean.index_select(
                   -2, self.region_of_node))
        return _own_rows(out, varphi.shape[-2], axis)


class ConsensusDiagnostics(NamedTuple):
    """Per-iteration observability record of `ADMMConsensus` (stacked
    along a leading time axis on `VBRun.consensus_diag`).

    primal_resid : RMS norm of the Eq. 39 disagreement.
    dual_resid : RMS norm of rho (phi^t - phi^{t-1}).
    rho : the penalty.
    kappa : the dual step-size ramp applied (Eq. 40).
    clip_count : nodes whose Eq. 38b projection moved the iterate.
    reset_count : nodes whose duals were reset (0: plain Algorithm 2).
    dual_on : 1.0 once the dual ascent is active (always, when plain).
    link_frac : fraction of the graph's links alive (1.0: static).
    """

    primal_resid: torch.Tensor
    dual_resid: torch.Tensor
    rho: torch.Tensor
    kappa: torch.Tensor
    clip_count: torch.Tensor
    reset_count: torch.Tensor
    dual_on: torch.Tensor
    link_frac: torch.Tensor


class ADMMConsensus(_CombineTopology):
    """Consensus ADMM in natural-parameter space (Algorithm 2), plus the
    reference's adaptive-penalty subsystem (all off by default, which
    keeps Algorithm 2 verbatim).

    Per iteration and node i with neighbours N_i (|N_i| = d_i):

      (38a) phi_i <- [phi*_i - 2 lam_i + rho sum_{j in N_i}(phi_i + phi_j)]
                     / (1 + 2 rho d_i)
      (38b) phi_i <- Proj_Omega(phi_i)                  (if project=True)
      (39)  lam_i <- lam_i + kappa_t rho/2 sum_{j in N_i}(phi_i - phi_j)
      (40)  kappa_t = 1 - 1/(1 + xi t)^2

    The subsystem (docs/admm-convergence.md of the reference):

    * `adaptive_rho` — residual balancing every `adapt_every` iterations
      of dual activity (`residual_balanced_rho` with `mu`, `tau_incr`,
      `tau_decr`, `rho_min`, `rho_max`); it turns the two below on
      ("auto").
    * `dual_warmup` — the Eq. 39 ascent stays off until the dual residual
      has been under `warmup_tol` x the primal residual for
      `warmup_window` consecutive iterations; the Eq. 40 ramp counts from
      activation.
    * `per_block` — one penalty per natural-parameter block
      (`model.block_labels()`), each balanced on its own residuals.
    * `dual_reset` — where the Eq. 38b projection moved a node's iterate,
      its duals are multiplied by this factor (0.0 = reset) and the kappa
      ramp restarts.
    * `lam_max` — clip each dual coordinate to +-lam_max |phi*_i|.

    The adaptive carry is (duals, rho, consecutive-stable count, iterations
    since dual activation, gate-open flag), all tensors: the step decides
    with `torch.where`, never on the host.  `link_drop` / `link_mask_fn`
    couple only the nodes whose link is up at iteration t.  Algorithm 2
    has no natural-gradient step, so `schedule` does not apply.

    `adj` is the dense (N, N) adjacency or a `network.SparseGraph`; both
    forms share `step` and `_adaptive_step` through `_graph_ops`'
    (degrees, neighbour sum, live fraction), the sparse one a segmented
    sum over the (gated) directed edges.

    >>> adj = torch.tensor([[0.0, 1.0], [1.0, 0.0]])
    >>> adapt = ADMMConsensus(adj, adaptive_rho=True)
    >>> adapt.dual_warmup, adapt.dual_reset     # "auto" resolution
    (True, 0.0)
    """

    uses_schedule = False
    emits_diagnostics = True
    # stays on the fleet's eager loop: the Eq. 38b projection (on by
    # default) calls `torch.linalg.eigh`, which reads its error flags back
    # on the host (`aten::any`, `_local_scalar_dense`) every iteration
    sync_free_step = False

    def __init__(self, adj, rho: float = 0.5, xi: float = 0.05,
                 project: bool = True, lam_max: float | None = None,
                 adaptive_rho: bool = False, mu: float = 10.0,
                 tau_incr: float = 2.0, tau_decr: float = 2.0,
                 adapt_every: int = 10, rho_min: float = 1e-3,
                 rho_max: float = 1e3, per_block: bool = False,
                 dual_warmup: bool | str = "auto", warmup_tol: float = 1e-3,
                 warmup_window: int = 10,
                 dual_reset: float | None | str = "auto",
                 clip_tol: float = 1e-9, link_drop: float = 0.0,
                 link_seed: int = 0, link_mask_fn=None):
        self.sparse = isinstance(adj, network_lib.SparseGraph)
        self.adj = adj if self.sparse else _as_tensor(adj)
        self.links = _LinkSchedule(link_drop, link_seed, link_mask_fn)
        self.rho = rho
        self.xi = xi
        self.project = project
        self.lam_max = lam_max
        self.adaptive_rho = adaptive_rho
        self.mu = mu
        self.tau_incr = tau_incr
        self.tau_decr = tau_decr
        self.adapt_every = adapt_every
        self.rho_min = rho_min
        self.rho_max = rho_max
        self.per_block = per_block
        self.dual_warmup = (adaptive_rho if dual_warmup == "auto"
                            else bool(dual_warmup))
        self.warmup_tol = warmup_tol
        self.warmup_window = warmup_window
        self.dual_reset = ((0.0 if adaptive_rho else None)
                           if dual_reset == "auto" else dual_reset)
        self.clip_tol = clip_tol
        self._labels = {}          # (device, dtype) -> (labels, one-hot)

    @property
    def _plain(self) -> bool:
        """True = Algorithm 2 verbatim."""
        return not (self.adaptive_rho or self.per_block or self.dual_warmup
                    or self.dual_reset is not None)

    def shard_inputs(self) -> dict:
        # sparse: the edge arrays are not per-node rows; the neighbour
        # sum gathers, reduces and keeps its local rows
        return {} if self.sparse else {"adj": self.adj}

    def init_carry(self, phi0, model=None):
        lam0 = torch.zeros_like(phi0)                 # duals lambda_i
        if self._plain:
            return lam0
        dev = phi0.device
        return (lam0, self._rho0(model, phi0.dtype, dev),
                torch.zeros((), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=phi0.dtype, device=dev),
                torch.full((), not self.dual_warmup, dtype=torch.bool,
                           device=dev))

    def carry_specs(self):
        # the duals are per node; the penalty and the gate state are the
        # same on every rank
        if self._plain:
            return sharding.NODE
        return (sharding.NODE, None, None, None, None)

    def _n_blocks(self, model) -> int:
        return int(np.max(model.block_labels())) + 1

    def _rho0(self, model, dtype, device):
        shape = (self._n_blocks(model),) if self.per_block else ()
        return torch.full(shape, self.rho, dtype=dtype, device=device)

    def _block_onehot(self, model, dtype, device):
        """(labels (P,), one-hot (P, n_blocks)) on the run's device, made
        once (a copy from the host each iteration would sync)."""
        key = (str(device), dtype)
        if key not in self._labels:
            labels = torch.as_tensor(model.block_labels().astype(np.int64),
                                     device=device)
            onehot = torch.nn.functional.one_hot(
                labels, self._n_blocks(model)).to(dtype)
            self._labels[key] = (labels, onehot)
        return self._labels[key]

    def init_diag(self, model, phi0):
        dt, dev = phi0.dtype, phi0.device
        rho0 = self._rho0(model, dt, dev)
        resid_shape = rho0.shape if self.per_block else ()
        zi = torch.zeros((), dtype=torch.int32, device=dev)
        return ConsensusDiagnostics(
            primal_resid=torch.zeros(resid_shape, dtype=dt, device=dev),
            dual_resid=torch.zeros(resid_shape, dtype=dt, device=dev),
            rho=rho0, kappa=torch.zeros((), dtype=dt, device=dev),
            clip_count=zi, reset_count=zi.clone(),
            dual_on=torch.zeros((), dtype=dt, device=dev),
            link_frac=torch.ones((), dtype=dt, device=dev))

    @staticmethod
    def _block_norms(zs, onehot=None, *, axis=None) -> tuple:
        """RMS norms of each (..., N, P) stack in `zs`: per block ((...,
        n_blocks)) given the one-hot block map, else one per leading
        index (a scalar for a solo session); the node axis reduced over
        every rank under the executor, in ONE `psum` for all of `zs`."""
        sqs = [(z * z).sum(-2) for z in zs]
        n = zs[0].shape[-2]
        if axis is not None:
            sqs = collectives.psum(torch.stack(sqs), axis).unbind(0)
            n *= collectives.axis_size(axis)
        if onehot is not None:
            return tuple(torch.sqrt((sq @ onehot) / (onehot.sum(0) * n))
                         for sq in sqs)
        return tuple(torch.sqrt(sq.sum(-1) / (n * zs[0].shape[-1]))
                     for sq in sqs)

    def _graph_ops(self, phi, t, axis=None, local=None):
        """(deg, neigh_sum, link_frac) of iteration t's graph: |N_i(t)|,
        z -> sum_{j in N_i(t)} z_j and the live fraction of the links.
        Dense: the adjacency masked by the surviving links, a product.
        Sparse: the directed edges gated by one coin per undirected link,
        a segmented sum, O(E + N) memory.  Under the executor (`axis`)
        deg and the sums are this rank's rows, over the gathered z."""
        n_local = phi.shape[-2]
        if self.sparse:
            g = self.adj
            if self.links.time_varying:
                keep_und = self.links.keep_edges(t, g.n_undirected,
                                                 phi.dtype, phi.device)
                keep_dir = keep_und.index_select(-1, g.edge_id)
                link_frac = keep_und.mean(-1)
                deg = _segment_sum(keep_dir, g.deg, -1)
            else:
                keep_dir = None
                link_frac = phi.new_ones(())
                deg = g.deg.to(phi.dtype)

            def neigh_sum(z):
                msg = _gathered(z, axis).index_select(-2, g.senders)
                if keep_dir is not None:
                    msg = msg * keep_dir[..., None]
                return _own_rows(_segment_sum(msg, g.deg, -2), n_local,
                                 axis)

            return _own_rows(deg, n_local, axis, -1), neigh_sum, link_frac
        adj = (self.adj if axis is None else local["adj"]).to(phi.dtype)
        if self.links.time_varying:
            keep = self.links.keep_matrix(t, self.adj.shape[-1], phi.dtype,
                                          phi.device)
            live = adj * _own_rows(keep, n_local, axis)   # (..., N, N)
            alive = live.sum((-2, -1))
            if axis is not None:
                alive = collectives.psum(alive, axis)
            link_frac = alive / self.adj.to(phi.dtype).sum()
        else:
            live = adj
            link_frac = phi.new_ones(())
        return (live.sum(-1),
                (lambda z: _dense_apply(live, _gathered(z, axis))),
                link_frac)

    def step(self, model, phi, carry, phi_star, t: int, schedule: Schedule,
             hyper=None, *, axis=None, local=None, diagnostics=True):
        # `hyper` entries (see `hyper_names`) override the penalty and the
        # ramp rate; under adaptive_rho the penalty lives in the carry, so
        # only xi is read from it there.  Without `diagnostics` the diag
        # is None and nothing (no collective either) is spent on it
        rho = self.rho if not hyper or "rho" not in hyper else hyper["rho"]
        xi = self.xi if not hyper or "xi" not in hyper else hyper["xi"]
        deg, neigh_sum, link_frac = self._graph_ops(phi, t, axis, local)
        if not self._plain:
            return self._adaptive_step(model, phi, carry, phi_star, deg,
                                       neigh_sum, link_frac, xi, axis=axis,
                                       diagnostics=diagnostics)
        lam = carry
        deg_c = deg[..., None]                        # (..., N, 1)
        rho_n = _per_slot(rho, phi)
        # (38a) primal
        phi_hat = (phi_star - 2.0 * lam
                   + rho_n * (deg_c * phi + neigh_sum(phi)))
        phi_hat = phi_hat / (1.0 + 2.0 * rho_n * deg_c)
        phi_new = model.project_to_domain(phi_hat) if self.project \
            else phi_hat                              # (38b)
        # (39) dual ascent with the kappa_t ramp (40)
        kappa = kappa_schedule(_float_t(t) + 1.0, xi)
        resid = deg_c * phi_new - neigh_sum(phi_new)
        # the factor kappa rho / 2 first, as a solo session's scalars
        lam_new = lam + _per_slot(kappa * rho / 2.0, phi) * resid
        if self.lam_max is not None:
            bound = self.lam_max * phi_star.abs()
            lam_new = torch.clamp(lam_new, -bound, bound)
        if not diagnostics:
            return phi_new, lam_new, None
        clip_count = ((phi_new - phi_hat).abs().amax(-1) > self.clip_tol
                      ).sum(-1).to(torch.int32)
        if axis is not None:
            clip_count = collectives.psum(clip_count, axis)
        primal_resid, dual_resid = self._block_norms(
            (resid, rho_n * (phi_new - phi)), axis=axis)
        diag = ConsensusDiagnostics(
            primal_resid=primal_resid, dual_resid=dual_resid,
            rho=torch.as_tensor(rho, dtype=phi.dtype, device=phi.device),
            kappa=torch.as_tensor(kappa, dtype=phi.dtype,
                                  device=phi.device),
            clip_count=clip_count,
            reset_count=torch.zeros((), dtype=torch.int32,
                                    device=phi.device),
            dual_on=phi.new_ones(()), link_frac=link_frac)
        return phi_new, lam_new, diag

    def _adaptive_step(self, model, phi, carry, phi_star, deg, neigh_sum,
                       link_frac, xi, *, axis=None, diagnostics=True):
        # a serving fleet's carry holds one (S,) entry per slot (rho
        # (S, n_blocks) per block), reshaped against (S, N, P) below
        lam, rho_vec, stable, t_act, active = carry
        dt = phi.dtype
        deg_c = deg[..., None]                        # (..., N, 1)
        if self.per_block:
            labels, onehot = self._block_onehot(model, dt, phi.device)
            rho_coord = rho_vec[..., labels][..., None, :]   # (..., 1, P)
        else:
            onehot = None
            rho_coord = _per_slot(rho_vec, phi)       # () or (S, 1, 1)

        # (38a) primal, with the (possibly per-block) penalty
        phi_hat = (phi_star - 2.0 * lam
                   + rho_coord * (deg_c * phi + neigh_sum(phi)))
        phi_hat = phi_hat / (1.0 + 2.0 * rho_coord * deg_c)
        phi_new = model.project_to_domain(phi_hat) if self.project \
            else phi_hat                              # (38b)
        clip_active = ((phi_new - phi_hat).abs().amax(-1)
                       > self.clip_tol)               # (..., N) clip fired
        # the count feeds the dual reset's ramp (any clip) and the diag;
        # under the executor one psum serves both, and none is issued
        # when neither reads it
        clip_count = clip_active.sum(-1).to(torch.int32)
        if axis is not None and (diagnostics
                                 or self.dual_reset is not None):
            clip_count = collectives.psum(clip_count, axis)

        resid = deg_c * phi_new - neigh_sum(phi_new)
        r_norm, s_norm = self._block_norms(
            (resid, rho_coord * (phi_new - phi)), onehot, axis=axis)
        if self.per_block:
            r_tot = torch.sqrt((r_norm ** 2).sum(-1))
            s_tot = torch.sqrt((s_norm ** 2).sum(-1))
        else:                                         # a one-term sum
            r_tot = torch.sqrt(r_norm ** 2)
            s_tot = torch.sqrt(s_norm ** 2)

        # dual warmup gate: open once s << r for warmup_window iterations
        if self.dual_warmup:
            stable = torch.where(s_tot < self.warmup_tol * r_tot,
                                 stable + 1, torch.zeros_like(stable))
            active = active | (stable >= self.warmup_window)
        zero = torch.zeros_like(t_act)
        t_act = torch.where(active, t_act + 1.0, zero)
        if self.dual_reset is not None:       # ramp reset on any clip
            t_act = torch.where(clip_count > 0, zero, t_act)
        kappa = torch.where(t_act > 0.0, kappa_schedule(t_act, xi), zero)

        # (39) dual ascent
        lam_new = lam + _per_slot(kappa, phi) * rho_coord / 2.0 * resid
        if self.lam_max is not None:
            bound = self.lam_max * phi_star.abs()
            lam_new = torch.clamp(lam_new, -bound, bound)
        if self.dual_reset is not None:
            lam_new = torch.where(clip_active[..., None],
                                  self.dual_reset * lam_new, lam_new)

        # residual balancing (Boyd Sec. 3.4.1), gated on dual activity
        if self.adaptive_rho:
            balanced = residual_balanced_rho(
                rho_vec, r_norm, s_norm, mu=self.mu, tau_incr=self.tau_incr,
                tau_decr=self.tau_decr, rho_min=self.rho_min,
                rho_max=self.rho_max)
            do = (active & (torch.fmod(t_act, float(self.adapt_every)) == 0.0)
                  & (t_act > 0.0))
            rho_vec = torch.where(do[..., None] if self.per_block else do,
                                  balanced, rho_vec)

        carry = (lam_new, rho_vec, stable, t_act, active)
        if not diagnostics:
            return phi_new, carry, None
        diag = ConsensusDiagnostics(
            primal_resid=r_norm, dual_resid=s_norm, rho=rho_vec,
            kappa=kappa, clip_count=clip_count,
            reset_count=(clip_count if self.dual_reset is not None
                         else torch.zeros_like(clip_count)),
            dual_on=active.to(dt), link_frac=link_frac)
        return phi_new, carry, diag


# ---------------------------------------------------------------------------
# Metrics (Eq. 46) + run result
# ---------------------------------------------------------------------------
def kl_to_reference(model, phi_nodes: torch.Tensor,
                    ref_phi: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-node KL to the ground-truth posterior (Eq. 46), (N,).

    `ref_phi` may be (P,) or a (n_refs, P) stack (component permutations
    of a mixture reference): the min over the stack is reported.  All
    nodes x references are evaluated as one batched computation.
    """
    if ref_phi is None:
        return phi_nodes.new_zeros(phi_nodes.shape[0])
    ref = ref_phi[None] if ref_phi.dim() == 1 else ref_phi
    return model.kl(phi_nodes[:, None, :], ref[None, :, :]).amin(1)


class VBRun(NamedTuple):
    phi: torch.Tensor           # (N, P) final natural parameters per node
    kl_mean: torch.Tensor       # (T,)   mean_i KL(q_i || ground truth)
    kl_std: torch.Tensor        # (T,)
    kl_nodes: torch.Tensor      # (T, N) per-node trajectory
    consensus_err: Any = None   # (T,)   mean_i ||phi_i - mean_j phi_j||^2
    consensus_diag: Any = None  # ConsensusDiagnostics (ADMM topologies)


# ---------------------------------------------------------------------------
# Sessions + explicit state
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class VBSession:
    """The static half of a VB session: model x topology x
    hyperparameters, plus the per-node data buffers (on the run's
    device).  `stream_data` is `data` as the model's hot path reads it
    (`model.stream_data`, e.g. cast once to the fused kernel's streaming
    dtype), or `data` itself for a model without `stream_data`; streaming
    minibatches gather from it.  `minibatch` is the session's
    `MinibatchSpec` (None: full batch) and `base_mask` the (N, T) mask of
    `data` it subsamples.  `executor` is the session's `MeshExecutor`
    (None: the single-array executor); the buffers stay global either
    way, and each `vb_run` takes its rank's rows of them."""

    model: Any
    data: Any
    topology: Any
    schedule: Schedule
    replication: float
    ref_phi: Optional[torch.Tensor]
    diagnostics: bool
    metric_nodes: Optional[int]
    stream_data: Any
    minibatch: Optional[stream_lib.MinibatchSpec] = None
    base_mask: Optional[torch.Tensor] = None
    executor: Optional[MeshExecutor] = None

    def with_data(self, data) -> "VBSession":
        """The same session over NEW per-node buffers (data arriving
        mid-flight).  Every leaf must keep its shape and dtype; the
        buffers move to the session's device, and the hot path's copy
        (`stream_data`) and the streaming mask are rebuilt from them."""
        dev = _leaves(self.data)[0].device
        data = _on_device(data, dev)
        old, new = _leaves(self.data), _leaves(data)
        if len(old) != len(new) or any(
                o.shape != n.shape or o.dtype != n.dtype
                for o, n in zip(old, new)):
            raise ValueError(
                "with_data: new buffers must match the session's data "
                "shapes/dtypes exactly (append into padding slots or "
                "replace same-shape buffers)")
        return dataclasses.replace(
            self, data=data, stream_data=_stream_data(self.model, data),
            base_mask=(None if self.minibatch is None
                       else self.model.data_mask(data)))


def _leaves(data) -> tuple:
    return (data,) if isinstance(data, torch.Tensor) else tuple(data)


def _on_device(data, dev):
    """The run's data on `dev`: one per-node array (e.g. LinRegModel's
    precomputed (N, P) phi* stack) or a tuple of them."""
    if isinstance(data, (torch.Tensor, np.ndarray)):
        return _as_tensor(data).to(dev)
    return tuple(_as_tensor(a).to(dev) for a in data)


def _stream_data(model, data):
    """The hot path's copy of the data (`model.stream_data`, e.g. cast
    once to the fused kernel's dtype), or the data itself."""
    stream = getattr(model, "stream_data", None)
    return data if stream is None else stream(data)


@dataclasses.dataclass(frozen=True)
class VBState:
    """Per-iteration state of a VB session.

    phi : (N, P) current natural parameters per node.
    t : ABSOLUTE iteration count (a Python int; every per-iteration
        quantity — eta_t, kappa_t — is a function of it).
    carry : topology carry (ADMM duals lambda_i), else None.
    diag : most recent `ConsensusDiagnostics` (ADMM), else None.
    session : the static `VBSession`.
    stream : `data.stream.StreamState` (the epoch's permutations and the
        SVRG anchors) when the session streams minibatches, else None.

    The arrays correspond to the reference checkpoint's `.phi`, `.t`,
    `.carry`, `.stream.<field>` and `.diag.<field>` entries
    (checkpoint/ckpt.py).
    """

    phi: torch.Tensor
    t: int
    carry: Any = None
    diag: Any = None
    session: Optional[VBSession] = None
    stream: Optional[stream_lib.StreamState] = None

    def replace(self, **kw) -> "VBState":
        return dataclasses.replace(self, **kw)

    def with_data(self, data) -> "VBState":
        """The state bound to updated per-node buffers (see
        `VBSession.with_data`)."""
        if self.session is None:
            raise ValueError("state has no session attached")
        return self.replace(session=self.session.with_data(data))


def vb_init(model, data, topology, *, schedule: Schedule = Schedule(),
            replication: float | None = None,
            init_phi: Optional[torch.Tensor] = None,
            ref_phi: Optional[torch.Tensor] = None,
            executor=None, backend=None, minibatch=None,
            diagnostics: bool = True, metric_nodes: Optional[int] = None,
            device=None) -> VBState:
    """Open a VB session and return its t=0 `VBState`.  Parameters are
    `run_vb`'s (minus `n_iters`)."""
    dev = device_lib.resolve(device)
    if executor is not None:
        if not isinstance(executor, MeshExecutor):
            raise TypeError(f"executor must be a dist.MeshExecutor or "
                            f"None, not {type(executor).__name__}")
        if metric_nodes is not None:
            raise ValueError("metric_nodes is only supported on the "
                             "single-array executor")
        collectives.check_device(executor, dev)
    model_dev = getattr(model, "device", dev)
    if torch.device(model_dev) != dev:
        raise ValueError(f"the model lives on {model_dev}, the run was "
                         f"asked for {dev}; build it with device={dev}")
    if backend is not None:
        with_backend = getattr(model, "with_backend", None)
        if with_backend is None:
            raise ValueError(
                f"{type(model).__name__} does not support compute-backend "
                "selection (no with_backend method)")
        from repro_torch.core import backends as backends_lib
        resolved = backends_lib.resolve(backend)
        if not resolved.supports(model):
            # a model this backend cannot run (the fused GMM kernel asked
            # for an HMM): the model's reference path, with a warning
            resolved = backends_lib.fallback(resolved, model)
        model = with_backend(resolved)
    if not topology.uses_schedule and schedule != Schedule():
        raise ValueError(
            f"{type(topology).__name__} has no natural-gradient step "
            "(Eq. 27a); it ignores `schedule` — pass the default")
    data = _on_device(data, dev)
    n_nodes = _leaves(data)[0].shape[0]
    if executor is not None and n_nodes % collectives.axis_size(executor):
        raise ValueError(
            f"{n_nodes} nodes do not split evenly over the executor's "
            f"{collectives.axis_size(executor)} ranks")
    # the hot path's copy of the data, cast once here, not per iteration
    stream_data = _stream_data(model, data)
    topology = topology.to(dev)
    if replication is None:
        replication = float(n_nodes)
    if init_phi is None:
        init_phi = model.init_phi().expand(n_nodes, model.flat_dim)
    init_phi = _as_tensor(init_phi).to(dev)
    if ref_phi is not None:
        ref_phi = _as_tensor(ref_phi).to(dev)

    stream0 = base_mask = None
    if minibatch is not None:
        if minibatch.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1: {minibatch}")
        if getattr(model, "take_minibatch", None) is None:
            raise ValueError(
                f"{type(model).__name__} does not support streaming "
                "minibatches (no take_minibatch/data_mask methods)")
        if minibatch.control_variate not in (None, "svrg"):
            raise ValueError(
                f"unknown control_variate {minibatch.control_variate!r}; "
                "expected None or 'svrg'")
        base_mask = model.data_mask(data)        # also validates the data
        capacity = int(base_mask.shape[1])
        if minibatch.batch_size > capacity:
            # covering the whole node = the bit-exact full-batch path
            minibatch = minibatch._replace(batch_size=capacity)
        stream0 = stream_lib.init_state(n_nodes, minibatch.seed, capacity,
                                        device=dev,
                                        perm_fn=minibatch.perm_fn)
        if minibatch.control_variate == "svrg" \
                and minibatch.batch_size < capacity:
            # SVRG anchors: the iterate and its full-batch optimum,
            # refreshed at each epoch change (`_iteration`); absent at
            # full batch, which is already the exact full-batch run
            stream0 = stream0._replace(
                anchor_phi=init_phi,
                anchor_full=model.local_optimum(stream_data, init_phi,
                                                float(replication)))
    session = VBSession(model, data, topology, schedule, float(replication),
                        ref_phi, diagnostics, metric_nodes, stream_data,
                        minibatch, base_mask, executor)
    return VBState(
        phi=init_phi, t=0, carry=topology.init_carry(init_phi, model),
        diag=topology.init_diag(model, init_phi) if diagnostics else None,
        session=session, stream=stream0)


def _iteration(ses: VBSession, phi, carry, st, t: int, hyper=None, *,
               axis=None, local=None):
    """ONE VB iteration at the absolute t: (phi', carry', stream', diag).
    `hyper` is the optional per-session constants dict (`hyper_names`);
    `axis` / `local` the mesh executor's (`_CombineTopology`), with `ses`
    then holding this rank's rows (`_local_session`).

    Streaming: gather this iteration's minibatch from the streamed data;
    its scaled mask keeps the statistics unbiased.  SVRG (anchors in the
    stream state) uses

        phi* = phi*_B(phi_t) - phi*_B(anchor_phi) + anchor_full,

    refreshing the anchor with the current iterate when t enters a new
    epoch (the two minibatch terms then cancel exactly).
    """
    model, mb, rep = ses.model, ses.minibatch, ses.replication
    if mb is None:
        data_t, st_new = ses.stream_data, st
    else:
        st_new, idx, mb_mask = stream_lib.advance(
            st, ses.base_mask, t, mb.batch_size, mb.perm_fn)
        data_t = model.take_minibatch(ses.stream_data, idx, mb_mask)
    if st is not None and st.anchor_phi is not None:
        refresh = st_new.epoch != st.epoch          # host integers
        if refresh:
            anchor_phi = phi
            anchor_full = model.local_optimum(ses.stream_data, phi, rep)
        else:
            anchor_phi, anchor_full = st.anchor_phi, st.anchor_full
        if axis is None:
            # 1 on the iterations that refreshed the SVRG anchor (a host
            # value: filed with no device work)
            taps.tap("stream/svrg_anchor_refresh", int(refresh), t=t)
        st_new = st_new._replace(anchor_phi=anchor_phi,
                                 anchor_full=anchor_full)
        phi_star = (model.local_optimum(data_t, phi, rep)
                    - model.local_optimum(data_t, anchor_phi, rep)
                    + anchor_full)
    else:
        phi_star = model.local_optimum(data_t, phi, rep)
    phi, carry, diag = ses.topology.step(model, phi, carry, phi_star, t,
                                         ses.schedule, hyper=hyper,
                                         axis=axis, local=local,
                                         diagnostics=ses.diagnostics)
    return phi, carry, st_new, diag


def session_step_fn(session: VBSession, *, axis=None, local=None):
    """The one-iteration kernel over raw state, with the data buffers as
    an ARGUMENT: fn(data, phi, carry, stream, t, hyper=None) -> (phi',
    carry', stream', diag).  Data other than the session's own goes
    through `VBSession.with_data` (same shapes and dtypes).  `hyper` is a
    per-session constants dict (`session_hyper`); None keeps the
    session's built-in values.  `axis` / `local`: the mesh executor's,
    the state and data then this rank's rows."""
    def fn(data, phi, carry, st, t, hyper=None):
        ses = session if data is session.data else session.with_data(data)
        return _iteration(ses, phi, carry, st, int(t), hyper=hyper,
                          axis=axis, local=local)

    return fn


def fleet_step_fn(session: VBSession, *, axis=None, local=None):
    """The one-iteration kernel over a serving FLEET: S sessions of this
    session's configuration (model, topology structure, schedule branch,
    replication, minibatch) batched along a leading slot axis.

        fn(data, stream_data, phi, carry, stream, t, hyper,
           may_redraw=True) -> (phi', carry', stream', diag)

    data / stream_data : the fleet's buffers, every leaf (S, N, ...);
        `stream_data` is the hot path's copy (`model.stream_data`, the
        data leaves themselves where no cast is needed).
    phi : (S, N, P); carry / stream : the topology carry and the
        `stream.StreamState` with a leading (S,) axis on every leaf
        (epoch an (S,) int64 tensor).
    t : (S,) int64 tensor, each slot's absolute iteration, on the device.
    hyper : {name: (S,) tensor}, the lifted constants (`session_hyper`).
    may_redraw : False when the caller knows no slot can enter a new
        stream epoch at this iteration (`stream.advance_fleet`).

    The local step runs ONCE over the fleet's data viewed as (S N, T,
    ...) and the iterates as (S N, P) (views, no copy): for the GMM on
    the fused backend one `gmm_estep_nodes` launch, whatever S is.  The
    topology then combines over dim 1 of (S, N, P), inside each slot;
    eta_t, kappa_t, the link coins, the gossip activations and the
    stream's epoch and window all come from the per-slot t.  Slot by
    slot the result is `session_step_fn`'s at that slot's t.  SVRG's
    full-batch anchor is recomputed for the whole fleet when
    `may_redraw` and kept where a slot's epoch did not change (one extra
    local step at such an iteration, as a solo session makes one at its
    own epoch change).

    `axis` / `local` run the fleet under the mesh executor: the slot
    axis stays a leading batch axis on every rank, the node axis is this
    rank's block of rows (a `_local_session`'s), and the topology
    combines over the ranks."""
    model, mb, rep = session.model, session.minibatch, session.replication
    topology, schedule = session.topology, session.schedule

    def fn(data, stream_data, phi, carry, st, t, hyper, may_redraw=True):
        S, N, P = phi.shape

        def flat(a):
            return a.reshape((S * N,) + a.shape[2:])

        def flat_tree(d):
            return flat(d) if isinstance(d, torch.Tensor) \
                else tuple(flat(a) for a in d)

        def optimum(d, phi_nodes):
            return model.local_optimum(
                d, phi_nodes.reshape(S * N, P), rep).reshape(S, N, P)

        if mb is None:
            data_t, st_new = flat_tree(stream_data), st
        else:
            st_new, idx, mb_mask = stream_lib.advance_fleet(
                st, model.data_mask(data), t, mb.batch_size, mb.perm_fn,
                may_redraw)
            data_t = model.take_minibatch(flat_tree(stream_data),
                                          flat(idx), flat(mb_mask))
        if st is not None and st.anchor_phi is not None:
            anchor_phi, anchor_full = st.anchor_phi, st.anchor_full
            if may_redraw:
                refresh = st_new.epoch != st.epoch                # (S,)
                new = refresh[:, None, None]
                full = optimum(flat_tree(stream_data), phi)
                anchor_phi = torch.where(new, phi, anchor_phi)
                anchor_full = torch.where(new, full, anchor_full)
                if axis is None:
                    # per slot, where a refresh was possible (elsewhere
                    # none)
                    taps.tap("stream/svrg_anchor_refresh", refresh, t=t)
            st_new = st_new._replace(anchor_phi=anchor_phi,
                                     anchor_full=anchor_full)
            phi_star = (optimum(data_t, phi) - optimum(data_t, anchor_phi)
                        + anchor_full)
        else:
            phi_star = optimum(data_t, phi)
        phi, carry, diag = topology.step(model, phi, carry, phi_star, t,
                                         schedule, hyper=hyper, axis=axis,
                                         local=local,
                                         diagnostics=session.diagnostics)
        return phi, carry, st_new, diag

    return fn


def hyper_names(topology, schedule: Schedule) -> tuple:
    """Names of the constants a (topology, schedule) pair reads each
    iteration as plain scalars, which a `hyper` dict may override:

    * a Robbins-Monro schedule (`eta_fixed=None` on a combine topology)
      reads `tau` / `d0`; a fixed eta is not lifted (eta_fixed == 1.0
      selects the one-shot jump as a branch);
    * `ADMMConsensus` reads `rho` and `xi`, except under `adaptive_rho`,
      where rho lives in the carry and only `xi` is read.

    >>> hyper_names(Diffusion(torch.eye(2)), Schedule())
    ('tau', 'd0')
    """
    names = []
    if getattr(topology, "uses_schedule", True) \
            and schedule.eta_fixed is None:
        names += ["tau", "d0"]
    if isinstance(topology, ADMMConsensus):
        names += ["xi"] if topology.adaptive_rho else ["rho", "xi"]
    return tuple(names)


def lifted_attr_names(topology) -> tuple:
    """Topology attributes whose per-session values reach the step
    another way (the `hyper` dict, or adaptive ADMM's carry): a superset
    of the topology's own `hyper_names` entries."""
    return ("rho", "xi") if isinstance(topology, ADMMConsensus) else ()


def session_hyper(topology, schedule: Schedule, dtype) -> dict:
    """The `hyper` dict of a session: each `hyper_names` entry as a 0-dim
    CPU tensor of `dtype` (a CPU scalar combines with tensors on any
    device)."""
    out = {}
    for n in hyper_names(topology, schedule):
        src = schedule if n in ("tau", "d0") else topology
        out[n] = torch.tensor(getattr(src, n), dtype=dtype)
    return out


def vb_run(state: VBState, n_iters: int) -> tuple[VBState, VBRun]:
    """Advance a session `n_iters` (>= 1) iterations; returns
    (state', VBRun) where the run covers the iterations of THIS call.
    Nothing in the loop waits for the device.

    Telemetry (`repro_torch.telemetry`): an `engine/vb_run{n_iters}`
    span; with host telemetry on, the `vb_run/*` series filed from the
    stacked per-iteration tensors after the loop; with taps on, the
    `vb/*` taps of each iteration, read once after the loop."""
    ses = state.session
    if ses is None:
        raise ValueError("VBState has no session attached — create states "
                         "with vb_init(...)")
    if n_iters < 1:
        raise ValueError(f"n_iters must be >= 1: {n_iters}")
    with telemetry.span("engine/vb_run", n_iters=int(n_iters)):
        return _vb_run_body(state, ses, n_iters)


def _vb_run_body(state, ses, n_iters):
    run_steps = _scan_steps if ses.executor is None else _run_vb_sharded
    phi, carry, st, kls, msds, diags = run_steps(
        ses, state.phi, state.carry, state.stream, state.t, n_iters)
    stacked = None
    if diags and diags[-1] is not None:
        stacked = type(diags[-1])(*(torch.stack(f) for f in zip(*diags)))
    state_new = state.replace(phi=phi, t=state.t + n_iters, carry=carry,
                              stream=st,
                              diag=diags[-1] if ses.diagnostics
                              else state.diag)
    run = VBRun(phi=phi, kl_mean=kls.mean(1),
                kl_std=kls.std(1, correction=0), kl_nodes=kls,
                consensus_err=torch.stack(msds) if ses.diagnostics
                else None,
                consensus_diag=stacked)
    if telemetry.enabled():
        _file_run_series(run, state.t, n_iters)
    return state_new, run


def _scan_steps(ses, phi, carry, st, t0: int, n_iters: int, *, axis=None,
                local=None):
    """`n_iters` iterations from the absolute t0, the loop of both
    executors: (phi, carry, stream, KLs (T, N), [msd], [diag]).  Under
    the executor (`axis`) everything is this rank's rows, and the
    consensus error's mean and msd are reduced over the ranks (`pmean`).
    The per-iteration `vb/*` taps run on the single-array executor only,
    as in the reference."""
    model = ses.model
    kls, msds, diags = [], [], []
    window = taps.open_window(n_iters) if axis is None else None
    with taps.collecting(window):
        for t in range(t0, t0 + n_iters):
            phi, carry, st, diag = _iteration(ses, phi, carry, st, t,
                                              axis=axis, local=local)
            phi_m = phi if ses.metric_nodes is None \
                else phi[:ses.metric_nodes]
            kls.append(kl_to_reference(model, phi_m, ses.ref_phi))
            if ses.diagnostics:
                mean = phi.mean(0)
                if axis is not None:
                    mean = collectives.pmean(mean, axis)
                msd = ((phi - mean) ** 2).mean()
                if axis is not None:
                    msd = collectives.pmean(msd, axis)
                msds.append(msd)
                diags.append(diag)
            if window is not None:
                if ses.diagnostics:
                    _tap_iteration(kls[-1], msds[-1], diag, t)
                else:
                    _tap_iteration(kls[-1], 0.0, None, t)
    if window is not None:
        window.flush()
    return phi, carry, st, torch.stack(kls), msds, diags


def _local_session(ses: VBSession, ex: MeshExecutor, n_local: int,
                   data_spec) -> VBSession:
    """This rank's view of a session: its rows of the data buffers (the
    hot path's copy and the streaming mask too; `data_spec` from
    `sharding.vb_node_specs`), and a minibatch `perm_fn` cut to its rows
    (`stream.local_spec`)."""
    def take(tree, spec=data_spec):
        return sharding.local_tree(tree, spec, ex, n_local)

    return dataclasses.replace(
        ses, data=take(ses.data), stream_data=take(ses.stream_data),
        base_mask=take(ses.base_mask, sharding.NODE),
        minibatch=_local_minibatch(ses.minibatch, ex, n_local))


def _local_minibatch(mb, ex: MeshExecutor, n_local: int):
    """A minibatch spec whose `perm_fn` is cut to this rank's rows
    (`stream.local_spec`); None stays None."""
    if mb is None:
        return None
    return stream_lib.local_spec(mb, collectives.axis_index(ex) * n_local,
                                 n_local)


def _local_inputs(topology, ex: MeshExecutor, n_local: int) -> dict:
    """This rank's rows of the topology's `shard_inputs`, by the specs
    `sharding.vb_node_specs` gives them (for a run and for a fleet)."""
    inputs = topology.shard_inputs()
    keys = sorted(inputs)
    specs = sharding.vb_node_specs(None, has_carry=False,
                                   n_local=len(keys))[0][4:]
    return {k: sharding.local_tree(inputs[k], s, ex, n_local)
            for k, s in zip(keys, specs)}


def _run_vb_sharded(ses, phi0, carry0, stream0, t0: int, n_iters: int):
    """The mesh executor, SPMD (the reference's shard_map
    `_run_vb_sharded`): take this rank's contiguous block of rows of the
    data, phi, the carry's and the stream's per-node leaves and the
    topology's `shard_inputs` (`dist/sharding.vb_node_specs`), run the
    loop with the combines' collectives, then gather the final phi,
    carry and stream and the (T, N) KLs once, so every rank returns the
    whole state.  The diagnostics are reduced inside the step, the same
    on every rank."""
    ex = ses.executor
    n_local = phi0.shape[0] // collectives.axis_size(ex)
    has_carry = carry0 is not None
    in_specs, out_specs = sharding.vb_node_specs(
        ses.data, has_carry=has_carry, n_local=0,
        carry_specs=ses.topology.carry_specs() if has_carry else None,
        stream_specs=(None if stream0 is None
                      else stream_lib.state_specs(stream0)))
    local = _local_inputs(ses.topology, ex, n_local)
    phi, carry, st, kls, msds, diags = _scan_steps(
        _local_session(ses, ex, n_local, in_specs[0]),
        *(sharding.local_tree(v, s, ex, n_local)
          for v, s in zip((phi0, carry0, stream0), in_specs[1:4])),
        t0, n_iters, axis=ex, local=local)
    phi, carry, st, kls = (sharding.gather_tree(v, s, ex) for v, s in zip(
        (phi, carry, st, kls), out_specs[:4]))
    return phi, carry, st, kls, msds, diags


_ADMM_SERIES = ("rho", "primal_resid", "dual_resid")


def _tap_iteration(kl, msd, diag, t: int) -> None:
    """The reference's per-iteration `vb/*` taps (means filed at the
    window's end; `msd` is 0.0 without diagnostics, as there)."""
    taps.tap("vb/kl_mean", kl, t=t, mean=True)
    taps.tap("vb/consensus_msd", msd, t=t)
    if diag is not None and hasattr(diag, "rho"):
        for name in _ADMM_SERIES:
            taps.tap(f"vb/admm_{name}", getattr(diag, name), t=t, mean=True)


def _file_run_series(run: VBRun, t0: int, n_iters: int) -> None:
    """The reference's `vb_run/*` series, filed from the run's stacked
    tensors (one device-to-host copy each, after the loop)."""
    ts = np.arange(t0, t0 + n_iters)
    taps.record_series("vb_run/kl_mean", run.kl_mean, ts=ts)
    if run.consensus_err is not None:
        taps.record_series("vb_run/consensus_msd", run.consensus_err, ts=ts)
    diags = run.consensus_diag
    if diags is not None and hasattr(diags, "rho"):
        for name in _ADMM_SERIES:
            a = getattr(diags, name)
            taps.record_series(f"vb_run/admm_{name}",
                               a if a.dim() == 1
                               else a.reshape(a.shape[0], -1).mean(1),
                               ts=ts)


def vb_step(state: VBState) -> VBState:
    """Advance a session by ONE iteration (= `vb_run(state, 1)[0]`)."""
    return vb_run(state, 1)[0]


def run_vb(model, data, topology, *, n_iters: int,
           schedule: Schedule = Schedule(), replication: float | None = None,
           init_phi: Optional[torch.Tensor] = None,
           ref_phi: Optional[torch.Tensor] = None, executor=None,
           backend=None, minibatch=None, diagnostics: bool = True,
           metric_nodes: Optional[int] = None, device=None) -> VBRun:
    """Run distributed VB: `model` on `data` over `topology`.

    model : ConjugateExpModel (core/model.py), built on `device`
    data : per-node data tuple (x (N, T, D), mask (N, T)), or one (N, ...)
        array (LinRegModel's phi* stack); moved to device
    topology : FusionCenter | Isolated | Diffusion | RingDiffusion |
        PairwiseGossip | HierarchicalFusion | ADMMConsensus (the graph
        topologies dense or over a `network.SparseGraph`)
    n_iters : number of VB iterations
    schedule : eta_t of the natural-gradient step (27a); `ONE_SHOT` for
        the jump-to-optimum estimators
    replication : likelihood replication factor (App. A); default N
    init_phi : (N, P) initial naturals; default the prior at every node
    ref_phi : (P,) or (n_refs, P) reference for the Eq. 46 metric
    backend : per-run compute backend ("reference" | "fused" | a
        `core.backends.Backend`); None keeps the model's own.  A backend
        that does not support the model falls back to the reference
        backend with a warning (once per backend and model type).
    minibatch : `data.stream.MinibatchSpec` — stream per-node minibatches
        (and SVRG anchors) instead of the full batch; None = full batch
    diagnostics : also record the per-iteration consensus error
    metric_nodes : evaluate the Eq. 46 metric on the first rows only
    device : where the run executes; None = CUDA (raises without a card)
    executor : None = single-array (the node axis a plain tensor axis);
        `MeshExecutor(group)` = the node axis split over the group's
        ranks, SPMD (every rank calls with the same global inputs and
        gets the whole `VBRun`); the group's backend must serve `device`
        (NCCL for CUDA, gloo for the CPU), N must divide evenly, and
        `metric_nodes` is not supported

    Exactly `vb_run(vb_init(<same arguments>), n_iters)[1]`.
    """
    state = vb_init(model, data, topology, schedule=schedule,
                    replication=replication, init_phi=init_phi,
                    ref_phi=ref_phi, executor=executor, backend=backend,
                    minibatch=minibatch, diagnostics=diagnostics,
                    metric_nodes=metric_nodes, device=device)
    return vb_run(state, n_iters)[1]
