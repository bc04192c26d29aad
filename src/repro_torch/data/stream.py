"""Streaming minibatch layer for the VB engine (Algorithm 1, stochastic form).

Port of `repro.data.stream`.  The paper's Algorithm 1 is a stochastic
natural-gradient method: the Robbins-Monro schedule eta_t (Eqs. 22/29)
lets each node estimate its local optimum phi*_i from a random subsample
of its data.

* `MinibatchSpec(batch_size, seed, control_variate)` — the run-level
  request handed to `engine.run_vb(..., minibatch=)`.
* `node_keys(n_nodes, seed)` — one key per GLOBAL node index.
* `StreamState(keys, perm, epoch, anchor_phi, anchor_full)` — the carried
  sampler state of `engine.VBState`: the keys, the current epoch's
  permutations, the epoch (a host integer) and the SVRG anchors.
* `init_state`, `advance(state, base_mask, t, batch_size)` — the
  per-iteration sampler: it redraws the permutations only when the epoch
  changes (decided on the host from the integer t, no device sync) and
  returns gather indices plus a scaled mask.
* `minibatch_select` — the stateless sampler, the oracle `advance` is
  tested against.
* `advance_fleet` — `advance` over a serving fleet's leading slot axis,
  each slot at its own device-side t.
* `state_specs`, `local_spec` — the mesh executor's view: each rank
  holds its rows of the keys, permutations and anchors (the keys are of
  GLOBAL node indices, so the stream does not depend on the executor),
  and a `perm_fn`'s permutations are cut to its rows.

With taps on (`repro_torch.telemetry.taps`), both tap `stream/epoch`
each iteration: a host integer for a session, an (S,) record per slot in
a fleet.

Sampling is random reshuffling: epoch e = t // ceil(T/B) permutes each
node's T sample slots, and iteration t takes window t mod ceil(T/B) of
the permutation (wrapping modulo T, so every slot is visited at least
once an epoch), sorted.  Every selected valid point gets the constant
weight T/B: a slot lands in a window with probability B/T, so the
statistics (linear in the mask) are exactly unbiased, ragged nodes
included.  With B = T the window is the identity gather and the scale is
exactly 1.0: `MinibatchSpec(batch_size=T)` reproduces the full-batch run
bit for bit.

The permutations are the port's own: slot j of node i in epoch e gets the
key `hash32(seed, STREAM_PERMS, i, e, j)` (core/network.py, a
counter-based hash in int64 ops), and a stable sort of the keys orders
the slots.  The keys of one node are distinct (the hash is a bijection
of j), so the permutation is the same on the CPU and on the card.
`jax.random.permutation` cannot be reproduced, so `MinibatchSpec.perm_fn`
takes another source of permutations (the reference's, in the parity
tests), as `link_mask_fn` does for link coins.

Variance reduction (`control_variate="svrg"`): `StreamState` carries a
full-batch anchor, the iterate `anchor_phi` and its full-batch local
optimum `anchor_full`, refreshed at each epoch change by the engine, which
then uses phi*_B(phi_t) - phi*_B(anchor_phi) + anchor_full (both
minibatch terms on the same window): exactly unbiased, most of the
window's noise cancelled.  Inert (no anchors) when B covers the node.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import network
from repro_torch.telemetry import taps


class MinibatchSpec(NamedTuple):
    """Per-node minibatch request for a streaming `run_vb` call.

    batch_size : points visited per node per iteration (the E-step runs on
        an (N, batch_size, ...) gather).
    seed : base seed of the per-(node, epoch) reshuffling stream.
    control_variate : None (plain reshuffling) or "svrg" (module
        docstring).
    perm_fn : None (the port's own permutations), or perm_fn(epoch) ->
        (N, T) permutations of every node's slots (an array or a tensor),
        e.g. the reference's draws for a parity test.
    """

    batch_size: int
    seed: int = 0
    control_variate: Optional[str] = None
    perm_fn: Optional[Callable] = None


def node_keys(n_nodes: int, seed: int, device="cpu") -> torch.Tensor:
    """(N,) int64 per-node stream keys: the hash state after (seed,
    STREAM_PERMS, global node index), so a node's stream does not depend
    on how the node axis is laid out."""
    nodes = torch.arange(n_nodes, dtype=torch.int64, device=device)
    return network.absorb(network.seed_state(seed), network.STREAM_PERMS,
                          nodes)


class StreamState(NamedTuple):
    """Carried sampler state.

    keys : (N,) int64 per-node keys (`node_keys`); constant.
    perm : (N, T) int64 — epoch `epoch`'s permutation of each node's
        slots.
    epoch : the epoch `perm` belongs to (a Python int).
    anchor_phi, anchor_full : None, or (N, P) — the SVRG anchor iterate
        and its full-batch local optimum (control_variate="svrg").
    """

    keys: torch.Tensor
    perm: torch.Tensor
    epoch: int
    anchor_phi: Optional[torch.Tensor] = None
    anchor_full: Optional[torch.Tensor] = None


def epoch_perms(keys: torch.Tensor, epoch: int, capacity: int,
                perm_fn=None) -> torch.Tensor:
    """(N, T) int64 permutations of epoch `epoch`: the stable sort of the
    slots' keys hash32(seed, STREAM_PERMS, node, epoch, slot), or
    `perm_fn(epoch)` when given."""
    if perm_fn is not None:
        perm = perm_fn(epoch)
        perm = perm if isinstance(perm, torch.Tensor) \
            else torch.from_numpy(np.array(perm))
        return perm.to(device=keys.device, dtype=torch.int64)
    slots = torch.arange(capacity, dtype=torch.int64, device=keys.device)
    h = network.absorb(keys, int(epoch))[:, None]
    words = network.mix32(network.absorb(h, slots))
    return torch.sort(words, dim=1, stable=True).indices


def init_state(n_nodes: int, seed: int, capacity: int, *, device="cpu",
               perm_fn=None) -> StreamState:
    """Stream state at t = 0: the keys and epoch 0's permutations."""
    keys = node_keys(n_nodes, seed, device)
    return StreamState(keys, epoch_perms(keys, 0, capacity, perm_fn), 0)


def state_specs(state: StreamState) -> StreamState:
    """The mesh executor's specs of a carried `StreamState`
    (dist/sharding.py): the keys, the permutations and the SVRG anchors
    (when present) shard their node axis 0, the epoch replicates."""
    return StreamState(
        keys=0, perm=0, epoch=None,
        anchor_phi=None if state.anchor_phi is None else 0,
        anchor_full=None if state.anchor_full is None else 0)


def local_spec(spec: MinibatchSpec, row0: int,
               n_local: int) -> MinibatchSpec:
    """`spec` as a rank of the mesh executor sees it: a `perm_fn`'s
    (N, T) permutations cut to the rows [row0, row0 + n_local)."""
    if spec.perm_fn is None:
        return spec
    whole = spec.perm_fn

    def perm_fn(epoch):
        perm = whole(epoch)
        perm = perm if isinstance(perm, torch.Tensor) \
            else torch.from_numpy(np.array(perm))
        return perm[row0:row0 + n_local]

    return spec._replace(perm_fn=perm_fn)


def _window(perm: torch.Tensor, base_mask: torch.Tensor, chunk: int,
            batch_size: int):
    """Window `chunk` of the permutations, sorted, and its scaled mask."""
    T = base_mask.shape[1]
    pos = torch.arange(chunk * batch_size, (chunk + 1) * batch_size,
                       device=perm.device) % T
    idx = torch.sort(perm.index_select(1, pos), dim=1).values
    picked = torch.gather(base_mask, 1, idx)            # 0 where padding
    return idx, picked * (T / batch_size)


def _schedule(t: int, T: int, batch_size: int):
    batch_size = min(int(batch_size), T)
    n_chunks = -(-T // batch_size)                      # ceil: cover all
    return batch_size, int(t) // n_chunks, int(t) % n_chunks


def advance(state: StreamState, base_mask: torch.Tensor, t: int,
            batch_size: int, perm_fn=None):
    """Carried-permutation form of `minibatch_select` at the ABSOLUTE
    iteration t: returns (state', idx (N, B) int64, mb_mask (N, B) scaled
    mask).  The permutations are redrawn only when t enters a new epoch
    (a host-side test of the integer t), with the same draw the stateless
    sampler makes, so the two agree bit for bit, across a split run too.
    """
    batch_size, epoch, chunk = _schedule(t, base_mask.shape[1], batch_size)
    perm = state.perm
    if epoch != state.epoch:
        perm = epoch_perms(state.keys, epoch, base_mask.shape[1], perm_fn)
    # the epoch index per iteration (a host integer: no device work);
    # rollovers show as increments in the tapped series
    taps.tap("stream/epoch", epoch, t=t)
    idx, mb_mask = _window(perm, base_mask, chunk, batch_size)
    return state._replace(perm=perm, epoch=epoch), idx, mb_mask


def _fleet_epoch_perms(keys: torch.Tensor, epoch: torch.Tensor,
                       capacity: int, perm_fn=None) -> torch.Tensor:
    """(S, N, T) permutations of each slot's epoch: `epoch_perms` with a
    leading slot axis (keys (S, N), epoch (S,) int64), the same integers
    slot by slot.  A `perm_fn` hook is called once per slot with that
    slot's epoch, read on the host (the hook's one device sync)."""
    if perm_fn is not None:
        return torch.stack([epoch_perms(k, e, capacity, perm_fn)
                            for k, e in zip(keys, epoch.tolist())])
    slots = torch.arange(capacity, dtype=torch.int64, device=keys.device)
    h = network.absorb(keys, epoch[:, None])[..., None]        # (S, N, 1)
    words = network.mix32(network.absorb(h, slots))
    return torch.sort(words, dim=-1, stable=True).indices


def advance_fleet(state: StreamState, base_mask: torch.Tensor,
                  t: torch.Tensor, batch_size: int, perm_fn=None,
                  may_redraw: bool = True):
    """`advance` over a serving fleet: S sessions of one configuration,
    each at its own absolute iteration t[s] (an (S,) int64 tensor on the
    device, never read on the host).  `state` holds keys (S, N), perm
    (S, N, T), epoch (S,) int64 and the anchors (S, N, P); base_mask is
    (S, N, T).  Returns (state', idx (S, N, B), mb_mask (S, N, B)), slot
    by slot equal to `advance` at that slot's t.

    A slot enters a new epoch where its t does (t % ceil(T/B) == 0, t >
    0).  The new permutations are computed for every slot and taken by
    `torch.where` where the epoch changed: a hash and a sort of
    (S, N, T) keys.  `may_redraw=False` skips that work when the caller
    knows from its host bounds on every slot's t that no slot can enter
    an epoch at this iteration (the serving driver's `FleetGroup`)."""
    S, N, T = base_mask.shape
    batch_size = min(int(batch_size), T)
    n_chunks = -(-T // batch_size)
    epoch = torch.div(t, n_chunks, rounding_mode="floor")
    chunk = t - epoch * n_chunks
    perm = state.perm
    if may_redraw:
        new = _fleet_epoch_perms(state.keys, epoch, T, perm_fn)
        perm = torch.where((epoch != state.epoch)[:, None, None], new, perm)
    taps.tap("stream/epoch", epoch, t=t)        # per slot: (S,) epoch and t
    pos = (chunk[:, None] * batch_size
           + torch.arange(batch_size, device=t.device)) % T      # (S, B)
    idx = torch.sort(torch.gather(perm, 2, pos[:, None, :].expand(
        S, N, batch_size)), dim=-1).values
    picked = torch.gather(base_mask, 2, idx)            # 0 where padding
    return (state._replace(perm=perm, epoch=epoch), idx,
            picked * (T / batch_size))


def minibatch_select(keys: torch.Tensor, base_mask: torch.Tensor, t: int,
                     batch_size: int, perm_fn=None):
    """Whole-network draw at iteration t from scratch: (idx (N, B) int64
    indices into each node's sample axis, mb_mask (N, B) scaled mask).
    Deterministic in (seed, global node index, t)."""
    batch_size, epoch, chunk = _schedule(t, base_mask.shape[1], batch_size)
    perm = epoch_perms(keys, epoch, base_mask.shape[1], perm_fn)
    return _window(perm, base_mask, chunk, batch_size)
