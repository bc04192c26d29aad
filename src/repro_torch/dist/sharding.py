"""Which leaves of a VB session's state are row-sharded under the mesh
executor (port of `repro.dist.sharding.vb_node_specs`, the VB half).

A spec is the node axis of a leaf (an int: its rows are split over the
ranks, each holding one contiguous block) or None (replicated: every rank
holds the same value).  A spec given for a subtree applies to each of its
leaves, as a shard_map prefix spec does.  The rule: every per-node array
(the data leaves, phi, the topology carry's per-node part, the stream's
keys, permutations and SVRG anchors, the topology's `shard_inputs` rows)
shards its node axis 0; scalars (the ADMM penalty and gate state, the
stream's epoch) replicate; the (T, N) KL trajectories shard axis 1.  A
serving fleet's leaves carry a leading slot axis: `fleet_spec` moves each
node axis one to the right.

`local_tree` takes a rank's block of a global tree; `gather_tree` puts
the ranks' blocks back together (the executor's outputs), so every rank
ends with the complete state.
"""
from __future__ import annotations

import torch

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
