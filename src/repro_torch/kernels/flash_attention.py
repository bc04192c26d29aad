"""Blocked online-softmax (flash) attention with the GQA head index.

Port of `repro.kernels.flash_attention` together with the GQA wrapper of
`repro.kernels.ops.flash_attention`: q (B, S, Hq, hd), k/v (B, S, Hkv, hd)
-> (B, S, Hq, hd) in q's dtype, with causal and sliding-`window` masks.  On
the card it runs as a hand-written CUDA kernel (`csrc/flash_attention.cu`):
for bf16 a tensor-core kernel (wgmma products, TMA tile loads), for f32 a
CUDA-core kernel; their designs and bound are in the source's header
note.  The kernels read kv head `hq // (Hq / Hkv)` for query head `hq`:
the GQA repeat is an index, never a copy.

`flash_attention` is the wrapper: it validates the inputs, then calls
the custom op `repro_torch::flash_attention` (`flash_attention_op`),
which launches the kernel for CUDA tensors, runs the plain PyTorch
version (`flash_attention_plain`, materialised f32 logits) for CPU
tensors and gives meta tensors the output's shape (the dry run,
`launch.dryrun`).  Nothing falls back: a CUDA tensor launches the kernel
or raises.  `flash_attention.launches` counts the kernel launches (real
ones only).  `op_count` is the launch's operation and byte count: the
op's FLOP formula (`torch.utils.flop_counter`) and `chip_smoke.py`'s
bound.

Contracts, shared by the kernel and the plain version:
* f32 or bf16 in and out (q, k, v one dtype); logits, softmax and the
  accumulator in f32.
* A masked logit is -1e30 (not -inf) and the normaliser is
  max(l, 1e-30), as in the TPU kernel, so a row with nothing unmasked
  gives zeros, not NaN.
* Two launches on the same inputs are bit-identical (no atomics).
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

#: head dims the kernel is instantiated for (tests/test_kernels.py's sweep,
#: Yi-6B's 128 and RecurrentGemma-2B's 256)
HEAD_DIMS = (16, 32, 64, 128, 256)
#: query rows per block and keys per tile of the f32 kernel (simt::kBQ,
#: kBK in the source); the bf16 kernel's blocks take 128 query rows
BLOCK_Q = BLOCK_K = 64
#: K/V ring depth of the bf16 kernel (wg::kStages)
STAGES_BF16 = 2
#: shared memory a block may use on Hopper
MAX_SMEM_BYTES = 227 * 1024
NEG_INF = -1e30

_DTYPES = (torch.float32, torch.bfloat16)


def _lib():
    from repro_torch.kernels import build
    fn = build.load("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(hd: int, dtype=torch.float32) -> int:
    """Dynamic shared memory of one block.  f32: Q and K tiles transposed
    (strides BLOCK_Q + 4, BLOCK_K + 1), the V tile and the P tile.  bf16:
    the block's two 64-row query tiles, STAGES_BF16 K and V tiles, the
    mbarriers and 1 KB to align the tiles to the swizzle's 1024 bytes; at
    hd 256 one query tile (the two warpgroups split the output columns)."""
    if dtype == torch.bfloat16:
        q_tiles = 1 if hd > 128 else 2
        tiles = (q_tiles + 2 * STAGES_BF16) * 64 * hd * 2
        return tiles + 8 * (1 + 2 * STAGES_BF16) + 1024
    return 4 * (hd * (BLOCK_Q + 4) + hd * (BLOCK_K + 1) + BLOCK_K * hd
                + BLOCK_K * (BLOCK_Q + 4))


def _check(q, k, v, window):
    if torch.is_grad_enabled() and any(a.requires_grad
                                       for a in (q, k, v)):
        raise RuntimeError(
            "the kernel has no backward (nor has the JAX package's Pallas "
            "kernel): call it without gradients, or train on the plain "
            "path (use_kernels=False)")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be (B, S, H, hd): {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    if tuple(k.shape) != (B, S, Hkv, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be {(B, S, Hkv, hd)}: "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16: {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"k, v dtypes {k.dtype}, {v.dtype} != q's {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the kernel takes hd in {HEAD_DIMS}: hd={hd}")
    if window < 0:
        raise ValueError(f"window must be >= 0: {window}")
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.device != q.device:
            raise ValueError(f"{name} is on {a.device}, q on {q.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if a.device.type == "cuda" and a.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (TMA)")
    if smem_bytes(hd, q.dtype) > MAX_SMEM_BYTES:
        raise ValueError(f"hd={hd} needs {smem_bytes(hd, q.dtype)} B of "
                         f"shared memory; a Hopper block has "
                         f"{MAX_SMEM_BYTES}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B, S, Hq, hd), k/v (B, S, Hkv, hd) -> (B, S, Hq, hd), logits
    scaled by 1/sqrt(hd).

    CUDA tensors launch the kernel; CPU tensors run the plain version;
    meta tensors get the output's shape (`flash_attention_op`).
    """
    _check(q, k, v, window)
    return flash_attention_op(q, k, v, causal, int(window))


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# The launch as a custom op: a kernel a device
# ---------------------------------------------------------------------------
@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: int) -> torch.Tensor:
    """The wrapper's launch (validated inputs): the plain version on the
    CPU, the kernel on the card (`_launch`), the output's shape on meta
    (`_fake`).  A dispatch mode sees the call as one op
    (`launch.hlo_analysis` counts it with `op_count`'s formula)."""
    return flash_attention_plain(q, k, v, causal=causal, window=window)


@flash_attention_op.register_kernel("cuda")
def _launch(q, k, v, causal, window):
    B, S, Hq, hd = q.shape
    out = torch.empty_like(q)
    if B * S:
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), B, S, Hq, k.shape[2], hd,
                     int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(hd),
                     int(causal), int(window),
                     torch.cuda.current_stream(q.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"flash_attention kernel launch failed: "
                               f"cudaError {err}")
        flash_attention.launches += 1
    return out


@flash_attention_op.register_fake
def _fake(q, k, v, causal, window):
    return torch.empty_like(q)


def op_count(B, S, Hq, Hkv, hd, window=0, elem=2, causal=True) -> tuple:
    """(flops, bytes) of one launch: 4 hd flops per (query row, key it
    reaches) (QK^T and PV; a causal row reaches the keys up to itself,
    within the window), q, k, v read once and o written once at `elem`
    bytes an element."""
    i = np.arange(S)
    lo = np.maximum(0, i - window + 1) if window else np.zeros_like(i)
    hi = i + 1 if causal else np.full_like(i, S)
    flops = 4 * B * Hq * hd * int((hi - lo).sum())
    n_bytes = elem * (2 * B * S * Hq * hd + 2 * B * S * Hkv * hd)
    return flops, n_bytes


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flops(q_shape, k_shape, v_shape, causal, window, *, out_shape=None,
           **kwargs) -> int:
    B, S, Hq, hd = q_shape
    return op_count(B, S, Hq, k_shape[2], hd, window, causal=causal)[0]


# ---------------------------------------------------------------------------
# The plain PyTorch version (CPU path of the wrapper; the card's oracle)
# ---------------------------------------------------------------------------
def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int = 0):
    """The kernel's function with materialised f32 logits (the oracle
    `repro.kernels.ref.attention`, -1e30 masking), the GQA repeat written
    as a grouping of the query heads."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    qg = q.float().reshape(B, S, Hkv, Hq // Hkv, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(hd)
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= j <= i
    if window > 0:
        ok &= j > i - window
    logits = torch.where(ok, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return out.reshape(B, S, Hq, hd).to(q.dtype)
