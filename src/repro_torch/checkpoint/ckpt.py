"""Carry state across from the JAX reference (read side of its checkpoints).

Two kinds of state carry over.  For the VB engine: the prior posterior
(GMM, HMM, Normal-Gamma), the initial iterate and the session state (phi,
the absolute t, the ADMM duals, the last `ConsensusDiagnostics` and a
streaming session's current epoch: its permutations and SVRG anchors).
For the LM side stack: the model's weights (`lm_params_from_arrays`,
`load_reference_lm_checkpoint`).  The reference's
`repro.checkpoint.ckpt.save` writes a compressed .npz whose `__meta__`
entry is a JSON manifest mapping each pytree key path (`.phi`, `.t`,
`.carry`, `.stream.<field>`, `.diag.<field>`; `['blocks']['attn']['wq']`
for an LM's params) to an array name and dtype, with bf16 stored as a
uint16 view.  This module reads it with numpy alone.
"""
from __future__ import annotations

import json
import re

import numpy as np
import torch

from repro_torch.core.engine import VBState
from repro_torch.core.expfam import GMMPosterior
from repro_torch.core.linreg import NGPosterior
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


def _load(arr, like: torch.Tensor, key: str) -> torch.Tensor:
    t = _tensor(arr)
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"{key}: shape {tuple(t.shape)} != "
                         f"{tuple(like.shape)}")
    return t.to(device=like.device, dtype=like.dtype)


def _stream_from_arrays(get, like):
    """`like`'s stream state with the reference's current epoch: its
    permutations, the epoch and the SVRG anchors.  The reference's keys
    are not carried: the port draws its own permutations from the next
    epoch on (or the session's `perm_fn`)."""
    epoch = np.asarray(get(".stream.epoch"))
    if epoch.shape != ():
        raise ValueError(f".stream.epoch: shape {epoch.shape} != ()")
    perm = _load(get(".stream.perm"), like.perm, ".stream.perm")
    anchors = {}
    for f in ("anchor_phi", "anchor_full"):
        if getattr(like, f) is not None:
            anchors[f] = _load(get(f".stream.{f}"), getattr(like, f),
                               f".stream.{f}")
    return like._replace(perm=perm, epoch=int(epoch), **anchors)


def state_from_arrays(arrays: dict, like: VBState) -> VBState:
    """`like` (a `vb_init` state of the same configuration) with its
    arrays replaced by the reference checkpoint's; shapes are checked.
    A streaming session resumes the reference's epoch mid-way
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
        carry = _load(get(".carry"), carry, ".carry")
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


def lm_params_from_arrays(cfg, arrays: dict, *, device, dtype=None):
    """The port's `LM` with the JAX package's params, given as `ckpt.save`
    flattens them: {keystr path: array}.  A homogeneous stack's arrays carry
    a leading n_layers axis (`['blocks']['attn']['wq']`, split here into
    one tensor per layer); a list of layers carries an index
    (`['blocks'][0]['attn']['wq']`).  Shapes are checked against `cfg`;
    a missing or extra key raises.  `dtype` (a torch dtype) overrides the
    config's param dtype; the f32 SSM parameters stay f32."""
    if dtype is not None:
        cfg = cfg.replace(param_dtype=str(dtype).removeprefix("torch."))
    lm = LM(cfg, device=device, init=False)
    want = dict(lm.named_parameters())
    stacked = _homogeneous(cfg)
    got = {}
    for key, arr in arrays.items():
        parts = _key_parts(key)
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
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise KeyError(f"params do not match {cfg.name}: missing {missing}, "
                       f"extra {extra}")
    with torch.no_grad():
        for name, p in want.items():
            p.copy_(_load(got[name], p, name))
    return lm


def load_reference_lm_checkpoint(path: str, cfg, *, device, dtype=None):
    """An `LM` with the weights of a JAX-saved params checkpoint (see
    `lm_params_from_arrays`)."""
    return lm_params_from_arrays(cfg, read_npz(path), device=device,
                                 dtype=dtype)
