"""Request-admission helpers shared by the serving engines (port of
`repro.serving.admission`).

Both serving stacks admit heterogeneous requests and must turn them into
fixed-shape device batches:

* the LM `serving.engine.Engine` admits variable-length prompts and packs
  them into one right-aligned (B, L) token batch (`right_aligned_batch`),
  grouping prompts into waves by `bucket_capacity` rung when bucketing is
  enabled;
* the VB `serving.vb_service.VBService` admits sensor-network sessions:
  requests whose data trees agree in shape and dtype (`shape_signature`)
  share a fleet, and the bucket ladder (`bucket_capacity` / `bucket_for`)
  lets near-same-shape sessions share one too: each session's per-node
  data capacity is padded up to the next rung with mask-zero slots
  (`model.pad_to_capacity`).  Everything here keys on the model's
  protocol surface only (`data_mask` / `pad_to_capacity`), so every model
  of the zoo buckets alike.

The trees are the port's: tensors and arrays, tuples (NamedTuples
included), lists and dicts.  `data_axis_mesh` is the mesh executor over
the default `torch.distributed` group (a one-rank group made in process
when none is initialised), which the serving smokes use.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch import telemetry
from repro_torch.dist import collectives
from repro_torch.dist.collectives import MeshExecutor, check_device

# Arrays at or under this many bytes are signed by content digest in
# `static_signature`; larger ones by identity (conservative: splits
# groups, never wrongly merges them, and never pays an O(size) hash on a
# big data buffer at admission time).
DIGEST_MAX_BYTES = 1 << 16


def bucket_capacity(n: int, *, growth: float = 2.0,
                    min_size: int = 8) -> int:
    """Smallest ladder rung >= n.  Rungs start at `min_size` and grow
    geometrically by `growth` (2.0 = power-of-two; ~1.25 gives finer
    boundaries at the cost of more distinct batch shapes).

    >>> [bucket_capacity(n) for n in (1, 8, 9, 25, 64, 65)]
    [8, 8, 16, 32, 64, 128]
    >>> bucket_capacity(25, growth=1.25, min_size=8)   # 8,10,13,17,22,28
    28
    """
    if n < 1:
        raise ValueError(f"capacity must be >= 1: {n}")
    if growth <= 1.0:
        raise ValueError(f"growth must be > 1.0: {growth}")
    cap = int(min_size)
    while cap < n:
        # max(+1) keeps the ladder strictly increasing for tiny growth
        cap = max(cap + 1, int(-(-cap * growth // 1)))
    # bucket-decision observability: which rungs admissions land on, and
    # how many padded slots each decision costs
    telemetry.inc("admission_bucket_total", rung=cap)
    telemetry.inc("admission_padded_slots_total", value=cap - n)
    return cap


def right_aligned_batch(seqs, length: int | None = None,
                        dtype=np.int32, pad_value: int = 0) -> np.ndarray:
    """Stack variable-length 1-D sequences into a right-aligned (B, L)
    array (left-padded with `pad_value`), the layout the LM prefill
    expects.  `length` pads to a fixed L and must cover the longest
    sequence (ValueError otherwise — truncation is the caller's policy);
    default: the longest sequence.

    >>> right_aligned_batch([[1, 2, 3], [7]]).tolist()
    [[1, 2, 3], [0, 0, 7]]
    >>> right_aligned_batch([[1, 2]], length=4).tolist()
    [[0, 0, 1, 2]]
    """
    seqs = [np.asarray(s, dtype) for s in seqs]
    longest = max((s.shape[0] for s in seqs), default=0)
    if length is None:
        length = longest
    if length < longest:
        raise ValueError(f"length {length} < longest sequence {longest}")
    out = np.full((len(seqs), length), pad_value, dtype)
    for i, s in enumerate(seqs):
        if s.shape[0]:
            out[i, length - s.shape[0]:] = s
    return out


def bucket_for(signature: tuple, *, growth: float = 2.0,
               min_size: int = 8) -> tuple:
    """Bucketed admission key: a `shape_signature` with every array
    entry's SECOND axis (the per-node sample/capacity axis of stacked
    sensor-network data) rounded up to its ladder rung.  Two sessions
    whose signatures bucket equal may share one fleet once their data is
    padded to the rung (`model.pad_to_capacity`).

    >>> a = shape_signature((torch.zeros(4, 25, 2), torch.zeros(4, 25)))
    >>> b = shape_signature((torch.zeros(4, 32, 2), torch.zeros(4, 32)))
    >>> bucket_for(a) == bucket_for(b)
    True
    >>> bucket_for(a) == bucket_for(shape_signature(torch.zeros(5, 25)))
    False
    """
    def one(entry):
        shape, dtype = entry
        if len(shape) >= 2:
            shape = (shape[0],
                     bucket_capacity(shape[1], growth=growth,
                                     min_size=min_size)) + shape[2:]
        return (shape, dtype)

    return (signature[0],) + tuple(one(e) for e in signature[1:])


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _flatten(tree):
    """(leaves, structure string) of a tree of tensors/arrays in tuples,
    NamedTuples, lists and dicts (None is an empty subtree, as in JAX).
    The structure string names every container and its arity, so two
    trees sign equal iff they have the same layout."""
    if tree is None:
        return [], "None"
    if _is_leaf(tree):
        return [tree], "*"
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        return ([leaf for p in parts for leaf in p[0]],
                "dict(" + ",".join(f"{k!r}:{p[1]}"
                                   for k, p in zip(keys, parts)) + ")")
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(v) for v in tree]
        name = type(tree).__name__
        return ([leaf for p in parts for leaf in p[0]],
                f"{name}(" + ",".join(p[1] for p in parts) + ")")
    return [tree], "*"


def _dtype_name(leaf) -> str:
    """A leaf's dtype as the reference names it ("float64", not
    "torch.float64")."""
    dt = getattr(leaf, "dtype", None)
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return str(np.asarray(leaf).dtype) if dt is None else str(dt)


def shape_signature(tree) -> tuple:
    """Hashable shape/dtype signature of a tree: requests whose data
    signatures (and static configuration) agree may share one batch.

    >>> a = (torch.zeros(3, 4), torch.zeros(3, dtype=torch.int32))
    >>> b = (torch.ones(3, 4), torch.ones(3, dtype=torch.int32))
    >>> shape_signature(a) == shape_signature(b)
    True
    >>> shape_signature(a) == shape_signature((a[0],))
    False
    """
    leaves, structure = _flatten(tree)
    return (structure,) + tuple(
        (tuple(np.shape(leaf)), _dtype_name(leaf)) for leaf in leaves)


def _host_array(a) -> np.ndarray:
    """A host array of a tensor or array (a card tensor is copied to the
    host: admission is host-side)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy()
    return np.asarray(a)


def static_signature(obj, *, ignore: tuple = ()):
    """Hashable structural signature of a model/topology configuration.

    Two separately-constructed objects of the same type whose attributes
    agree produce the same signature and therefore share a fleet group.
    Small arrays and tensors (<= DIGEST_MAX_BYTES) are signed by CONTENT
    (shape, dtype, sha1 of the bytes), so `Diffusion(W)` built twice over
    two equal-valued weight matrices signs equal; larger ones fall back to
    object identity, as does anything unrecognised (conservative: splits
    groups, never wrongly merges them).

    `ignore` drops the named TOP-LEVEL attributes from the signature: the
    serving driver strips the per-session hyperparameters that the engine
    lifts onto the fleet axis (`engine.lifted_attr_names`), so two
    `ADMMConsensus` topologies differing only in `rho` share a fleet.
    Private attributes (a leading underscore: caches, and state derived
    from the public attributes) are not part of the configuration.
    """
    if isinstance(obj, (int, float, bool, str, bytes, type(None))):
        return obj
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        nbytes = (obj.numel() * obj.element_size()
                  if isinstance(obj, torch.Tensor) else obj.nbytes)
        if nbytes <= DIGEST_MAX_BYTES:
            a = _host_array(obj)
            digest = hashlib.sha1(np.ascontiguousarray(a).tobytes())
            return ("arr", tuple(obj.shape), _dtype_name(obj),
                    digest.hexdigest())
        return ("arr", id(obj))
    if isinstance(obj, tuple):           # incl. NamedTuples (Schedule etc.)
        return (type(obj).__name__,) + tuple(static_signature(v)
                                             for v in obj)
    if hasattr(obj, "__dict__") or hasattr(obj, "__slots__"):
        names = (sorted(vars(obj)) if hasattr(obj, "__dict__")
                 else sorted(n for n in obj.__slots__ if hasattr(obj, n)))
        return (type(obj).__name__,) + tuple(
            (n, static_signature(getattr(obj, n)))
            for n in names if n not in ignore and not n.startswith("_"))
    try:
        hash(obj)
        return obj
    except TypeError:
        return ("id", id(obj))


def data_axis_mesh(axis: str = "data", device=None):
    """`MeshExecutor` with `axis` spanning every rank of the default
    `torch.distributed` group.  Without one, a one-rank group is made
    in-process over a `HashStore` (no port, no network): NCCL for a CUDA
    `device` (None = the card), gloo for the CPU.  A group that fails to
    initialise raises."""
    dev = device_lib.resolve(device)
    collectives.ensure_group(dev)
    ex = MeshExecutor(None, axis)
    check_device(ex, dev)
    return ex
