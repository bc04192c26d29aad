"""Checkpoints in the reference's file format: save, restore, resume.

`save(path, tree, step=None)` / `restore(path, like, step=None)` /
`latest_step(dir)` are the port of `repro.checkpoint.ckpt`, with its file
format: a compressed .npz whose `__meta__` entry is a JSON manifest
mapping each key path to an array name and dtype, bf16 stored as a uint16
view, step files `ckpt_{step:08d}.npz`, and an atomic write (a temporary
file renamed over the target, so a crashed save never corrupts the last
checkpoint).  The key paths are `jax.tree_util.keystr`'s: `.phi`, `.t`,
`.carry` (an array) or `.carry[i]` (a tuple, e.g. adaptive ADMM's),
`.stream.<field>`, `.diag.<field>` for a `VBState`; `['blocks'][0]...` for
an LM's params.  So either package reads the other's files.

What carries over.  For the VB engine: the prior posterior (GMM, HMM,
Normal-Gamma), the initial iterate and the session state (phi, the
absolute t, the topology carry, the last `ConsensusDiagnostics` and a
streaming session's current epoch: its permutations and SVRG anchors;
`.stream.keys` holds the port's (N,) int64 node keys, and a reference
file's (N, 2) keys are left for the session's own).  The session itself
(model, topology, data) is not saved: `restore` loads into the state of
a `vb_init` of the same configuration.  For the LM side stack: the
model's weights (`lm_params_from_arrays`, `load_reference_lm_checkpoint`)
and the JAX params tree of {parameter name: tensor} dicts (`lm_tree`: a
homogeneous stack's layers stacked on a leading axis), which
`training.train_step` uses to write and read a training state.
Everything is read and written with numpy alone.
"""
from __future__ import annotations

import json
import os
import re

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.engine import VBState
from repro_torch.core.expfam import GMMPosterior
from repro_torch.core.linreg import NGPosterior
from repro_torch.dist import sharding
from repro_torch.models.hmm import HMMPosterior
from repro_torch.models.model import LM, _homogeneous

_BF16 = "bfloat16"


def _fields(arrays, device, dtype):
    return (torch.as_tensor(np.array(a), dtype=dtype, device=device)
            for a in arrays)


def posterior_from_numpy(alpha, m, beta, W, nu, *, device,
                         dtype=torch.float64) -> GMMPosterior:
    """A GMMPosterior from host arrays (e.g. a reference prior)."""
    return GMMPosterior(*_fields((alpha, m, beta, W, nu), device, dtype))


def hmm_posterior_from_numpy(pi, trans, m, beta, W, nu, *, device,
                             dtype=torch.float64) -> HMMPosterior:
    """An HMMPosterior from host arrays (e.g. the reference's prior)."""
    return HMMPosterior(*_fields((pi, trans, m, beta, W, nu), device, dtype))


def ng_posterior_from_numpy(m, V, a, b, *, device,
                            dtype=torch.float64) -> NGPosterior:
    """An NGPosterior (linear regression, or PPCA's rows) from host
    arrays."""
    return NGPosterior(*_fields((m, V, a, b), device, dtype))


def read_npz(path: str) -> dict[str, np.ndarray]:
    """{key path: array} of a reference checkpoint."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        out = {}
        for key, info in meta.items():
            arr = z[info["name"]]
            if info["dtype"] == _BF16:
                # bf16 is stored as its uint16 bit pattern
                arr = torch.from_numpy(arr.astype(np.uint16).view(np.int16)
                                       ).view(torch.bfloat16)
            out[key] = arr
    return out


def _tensor(arr) -> torch.Tensor:
    """A tensor of a checkpoint array (a read-only numpy array is copied:
    it cannot back a tensor)."""
    if isinstance(arr, np.ndarray) and not arr.flags.writeable:
        arr = np.array(arr)
    return torch.as_tensor(arr)


def _check_shape(arr, like: torch.Tensor, key: str) -> None:
    if tuple(np.shape(arr)) != tuple(like.shape):
        raise ValueError(f"{key}: shape {tuple(np.shape(arr))} != "
                         f"{tuple(like.shape)}")


def _load(arr, like: torch.Tensor, key: str) -> torch.Tensor:
    _check_shape(arr, like, key)
    return _tensor(arr).to(device=like.device, dtype=like.dtype)


def _stream_from_arrays(get, like):
    """`like`'s stream state with the checkpoint's current epoch: its
    permutations, the epoch and the SVRG anchors.  The port's own (N,)
    node keys are loaded (they equal the session's: both come from the
    seed); the reference's (N, 2) keys are not: the port draws its own
    permutations from the next epoch on (or the session's `perm_fn`)."""
    epoch = np.asarray(get(".stream.epoch"))
    if epoch.shape != ():
        raise ValueError(f".stream.epoch: shape {epoch.shape} != ()")
    perm = _load(get(".stream.perm"), like.perm, ".stream.perm")
    keys = get(".stream.keys")
    keys = (_load(keys, like.keys, ".stream.keys")
            if tuple(np.shape(keys)) == tuple(like.keys.shape) else like.keys)
    anchors = {}
    for f in ("anchor_phi", "anchor_full"):
        if getattr(like, f) is not None:
            anchors[f] = _load(get(f".stream.{f}"), getattr(like, f),
                               f".stream.{f}")
    return like._replace(keys=keys, perm=perm, epoch=int(epoch), **anchors)


def _carry_from_arrays(get, like):
    """The topology carry by the reference's key paths: `.carry` for an
    array (plain ADMM's duals), `.carry[i]` for each leaf of a tuple
    (adaptive ADMM's (duals, rho, stable count, ramp, gate))."""
    if isinstance(like, torch.Tensor):
        return _load(get(".carry"), like, ".carry")
    return type(like)(_load(get(f".carry[{i}]"), leaf, f".carry[{i}]")
                      for i, leaf in enumerate(like))


def state_from_arrays(arrays: dict, like: VBState) -> VBState:
    """`like` (a `vb_init` state of the same configuration) with its
    arrays replaced by the checkpoint's (a reference file or the port's
    own); shapes are checked, each leaf takes `like`'s dtype and device.
    A streaming session resumes the saved epoch mid-way
    (`_stream_from_arrays`)."""
    def get(key):
        if key not in arrays:
            raise KeyError(f"checkpoint missing {key}")
        return arrays[key]

    t = np.asarray(get(".t"))
    if t.shape != ():
        raise ValueError(f".t: shape {t.shape} != ()")
    carry = like.carry
    if carry is not None:
        carry = _carry_from_arrays(get, carry)
    diag = like.diag
    if diag is not None:
        diag = type(diag)(**{
            f: _load(get(f".diag.{f}"), getattr(diag, f), f".diag.{f}")
            for f in diag._fields})
    stream = like.stream
    if stream is not None:
        stream = _stream_from_arrays(get, stream)
    return like.replace(phi=_load(get(".phi"), like.phi, ".phi"),
                        t=int(t), carry=carry, diag=diag, stream=stream)


def load_reference_checkpoint(path: str, like: VBState) -> VBState:
    """Resume a session the JAX package checkpointed: read its .npz and
    load it into `like` (see `state_from_arrays`)."""
    return state_from_arrays(read_npz(path), like)


# ---------------------------------------------------------------------------
# save / restore / latest_step (the reference's file format)
# ---------------------------------------------------------------------------
def _leaf_array(leaf) -> np.ndarray:
    """A host array of a leaf.  Python scalars take the reference's
    dtypes for a `VBState`'s `.t` and `.stream.epoch` (int32), bool and
    float64 otherwise."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16)
        return leaf.numpy()
    if isinstance(leaf, (bool, np.bool_)):
        return np.asarray(leaf, np.bool_)
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    if isinstance(leaf, float):
        return np.asarray(leaf, np.float64)
    return np.asarray(leaf)


def _flatten(tree, key: str = "", out: dict | None = None) -> dict:
    """{keystr path: leaf} of a tree of VBStates, NamedTuples, tuples,
    lists and dicts (None is an empty subtree, as in JAX)."""
    out = {} if out is None else out
    if tree is None:
        pass
    elif isinstance(tree, VBState):
        for name in ("phi", "t", "carry", "stream", "diag"):
            _flatten(getattr(tree, name), f"{key}.{name}", out)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            _flatten(getattr(tree, name), f"{key}.{name}", out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _flatten(v, f"{key}[{i}]", out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{key}[{k!r}]", out)
    else:
        out[key] = tree
    return out


def _step_path(path: str, step: int | None) -> str:
    return path if step is None else os.path.join(path,
                                                  f"ckpt_{step:08d}.npz")


def save(path: str, tree, step: int | None = None) -> str:
    """Write `tree` (a `VBState`, or a tree of tensors/arrays: dicts,
    lists, tuples, NamedTuples) to `path`, or to `path/ckpt_{step:08d}.npz`
    when `step` is given; returns the file's path.  Atomic: written to a
    temporary file, then renamed."""
    path = _step_path(path, step)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays, meta = {}, {}
    for i, (key, leaf) in enumerate(sorted(_flatten(tree).items())):
        name = f"a{i}"
        is_bf16 = isinstance(leaf, torch.Tensor) \
            and leaf.dtype == torch.bfloat16
        arrays[name] = _leaf_array(leaf)
        meta[key] = {"name": name,
                     "dtype": _BF16 if is_bf16 else str(arrays[name].dtype)}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, __meta__=np.frombuffer(
            json.dumps(meta).encode(), np.uint8), **arrays)
    os.replace(tmp, path)
    return path


def _unflatten(like, flat: dict, key: str = ""):
    """`like`'s structure with each leaf replaced by flat[its key path]
    (shape checked): a tensor leaf becomes a tensor on its device in the
    file's dtype, any other leaf a numpy array."""
    if like is None:
        return None
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, f), flat,
                                       f"{key}.{f}") for f in like._fields))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, flat, f"{key}[{i}]")
                          for i, v in enumerate(like))
    if isinstance(like, dict):
        return {k: _unflatten(v, flat, f"{key}[{k!r}]")
                for k, v in like.items()}
    if key not in flat:
        raise KeyError(f"checkpoint missing {key}")
    arr = flat[key]
    if tuple(np.shape(arr)) != tuple(np.shape(like)):
        raise ValueError(f"{key}: shape {tuple(np.shape(arr))} != "
                         f"{tuple(np.shape(like))}")
    if isinstance(like, torch.Tensor):
        return _tensor(arr).to(like.device)
    return np.asarray(arr)


def restore(path: str, like, step: int | None = None):
    """Load a checkpoint into the structure of `like`.  A `VBState`
    (a `vb_init` state of the same configuration) resumes through
    `state_from_arrays`: each leaf in `like`'s dtype and device, so a
    card's checkpoint continues on the CPU and back.  Any other tree
    takes the file's dtypes (shapes must match)."""
    arrays = read_npz(_step_path(path, step))
    if isinstance(like, VBState):
        return state_from_arrays(arrays, like)
    return _unflatten(like, arrays)


def latest_step(ckpt_dir: str) -> int | None:
    """The largest step of the `ckpt_{step:08d}.npz` files in `ckpt_dir`
    (None when there is none)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None


# ---------------------------------------------------------------------------
# LM weights
# ---------------------------------------------------------------------------
_KEY_PART = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def _key_parts(key: str) -> list:
    """`jax.tree_util.keystr` path -> its dict keys (str) and list
    indices (int): "['blocks'][0]['attn']['wq']" -> ['blocks', 0, 'attn',
    'wq']."""
    parts, pos = [], 0
    for m in _KEY_PART.finditer(key):
        if m.start() != pos:
            break
        parts.append(m.group(1) if m.group(2) is None else int(m.group(2)))
        pos = m.end()
    if pos != len(key) or not parts:
        raise ValueError(f"not a params key path: {key!r}")
    return parts


def _lm_named(cfg, arrays: dict, prefix: str = "",
              replica: int | None = None) -> dict:
    """{parameter name: array} of the JAX params tree under `prefix`
    (`ckpt.save`'s keystr paths).  A homogeneous stack's arrays carry a
    leading n_layers axis (`['blocks']['attn']['wq']`, split here into
    one array per layer); a list of layers carries an index
    (`['blocks'][0]['attn']['wq']`).  `replica` takes that index of a
    leading replica axis first (a consensus mode's state)."""
    stacked = _homogeneous(cfg)
    got = {}
    for key, arr in arrays.items():
        if prefix and not key.startswith(prefix + "["):
            continue
        parts = _key_parts(key[len(prefix):])
        if replica is not None:
            arr = _tensor(arr)[replica]
        if parts[0] == "blocks" and isinstance(parts[1], str) != stacked:
            raise ValueError(f"{key} does not match the layout of "
                             f"{cfg.name}'s layers in the JAX params ("
                             f"{'stacked' if stacked else 'a list'})")
        if parts[0] == "blocks" and stacked:
            arr = _tensor(arr)               # stacked over the layers
            if arr.shape[0] != cfg.n_layers:
                raise ValueError(f"{key}: leading axis {arr.shape[0]} != "
                                 f"n_layers {cfg.n_layers}")
            for i in range(cfg.n_layers):
                got[".".join(map(str, ["blocks", i, *parts[1:]]))] = arr[i]
        else:
            got[".".join(map(str, parts))] = arr
    return got


def _load_named(cfg, got: dict, want: dict, what: str) -> None:
    """Copy `got` into the tensors of `want` (same names; shapes checked,
    each cast to its tensor's dtype and device).  A DTensor of `want`
    takes this rank's block of its array."""
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise KeyError(f"{what} do not match {cfg.name}: missing {missing}, "
                       f"extra {extra}")
    with torch.no_grad():
        for name, p in want.items():
            if isinstance(p, DTensor):
                _check_shape(got[name], p, name)
                p.to_local().copy_(sharding.local_shard(
                    _tensor(got[name]), p.device_mesh, p.placements))
            else:
                p.copy_(_load(got[name], p, name))


def lm_params_from_arrays(cfg, arrays: dict, *, device, dtype=None):
    """The port's `LM` with the JAX package's params, given as `ckpt.save`
    flattens them: {keystr path: array} (see `_lm_named`).  Shapes are
    checked against `cfg`; a missing or extra key raises.  `dtype` (a
    torch dtype) overrides the config's param dtype; the f32 SSM, RG-LRU
    and router parameters stay f32."""
    if dtype is not None:
        cfg = cfg.replace(param_dtype=str(dtype).removeprefix("torch."))
    lm = LM(cfg, device=device, init=False)
    _load_named(cfg, _lm_named(cfg, arrays), dict(lm.named_parameters()),
                "params")
    return lm


def lm_tree(cfg, named: dict) -> dict:
    """The JAX params tree of {parameter name: tensor} (the model's
    parameters, its AdamW moments or its duals): nested dicts, with a
    homogeneous stack's layers stacked on a leading axis and a list of
    layers otherwise."""
    tree: dict = {}
    layers: dict = {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] == "blocks":
            layers.setdefault(int(parts[1]), {})[tuple(parts[2:])] = t
            continue
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t.detach()

    def nest(flat: dict) -> dict:
        out: dict = {}
        for path, t in flat.items():
            node = out
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = t
        return out

    blocks = [layers[i] for i in sorted(layers)]
    if _homogeneous(cfg):
        tree["blocks"] = nest({path: torch.stack([b[path].detach()
                                                  for b in blocks])
                               for path in blocks[0]})
    else:
        tree["blocks"] = [nest({p: t.detach() for p, t in b.items()})
                          for b in blocks]
    return tree


def load_reference_lm_checkpoint(path: str, cfg, *, device, dtype=None):
    """An `LM` with the weights of a JAX-saved params checkpoint (see
    `lm_params_from_arrays`)."""
    return lm_params_from_arrays(cfg, read_npz(path), device=device,
                                 dtype=dtype)
