"""Mamba-2 SSD chunked scan.

Port of `repro.kernels.ssd_scan` (wrapper `repro.kernels.ops.ssd_scan`):
x (B, S, H, P), dt (B, S, H), A (H,), Bm/Cm (B, S, N) -> (y (B, S, H, P),
final state (B, H, P, N)), the scalar-decay SSM

    state_t = exp(dt_t A) state_{t-1} + dt_t B_t x_t^T,   y_t = C_t . state_t

computed chunk by chunk.  On the card it runs as hand-written CUDA
(`csrc/ssd_scan.cu`): one call launches three kernels, chunk states, state
passing and chunk scan, through an f32 scratch of per-chunk states that
the wrapper allocates; their design and bound are in the source's header
note.

`ssd_scan` is the wrapper: it validates the inputs, then calls the
custom op `repro_torch::ssd_scan` (`ssd_scan_op`), which launches the
kernels for CUDA tensors, runs the plain PyTorch version
(`ssd_scan_plain`, the chunked algorithm of `models.mamba2.ssd_chunked`)
for CPU tensors and gives meta tensors the outputs' shapes (the dry run,
`launch.dryrun`).  Nothing falls back: a CUDA tensor launches the kernel
or raises.  `ssd_scan.launches` counts the wrapper's launches of the
kernels (one per call, the three passes together; real ones only).
`op_count` is the launch's operation and byte count: the op's FLOP
formula (`torch.utils.flop_counter`) and `chip_smoke.py`'s bound.

Contracts, shared by the kernel and the plain version:
* x (and y) f32 or bf16, Bm/Cm in x's dtype, dt and A f32; everything is
  f32 inside, y is cast to x's dtype once, the final state is f32.
* `chunk` is the TPU kernel's schedule: S % min(chunk, S) must be 0
  (ValueError otherwise, like the JAX wrapper's assert).  The result does
  not depend on it, and the CUDA kernel runs its own internal chunk of
  KERNEL_CHUNK positions.
* Two launches on the same inputs are bit-identical (no atomics).
* On the card N and P are multiples of 4 (4-wide tiles and loads) and
  P <= MAX_P (a head's x for a chunk is prefetched in registers).
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

#: the CUDA kernel's internal chunk (kL in the source)
KERNEL_CHUNK = 64
#: the largest head dim P the kernel takes
MAX_P = 64
#: shared memory a block may use on Hopper
MAX_SMEM_BYTES = 227 * 1024

_DTYPES = (torch.float32, torch.bfloat16)


def _lib():
    from repro_torch.kernels import build
    fn = build.load("ssd_scan").ssd_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(N: int, P: int) -> int:
    """Dynamic shared memory of the larger of the two staged passes' blocks:
    chunk states (B, the weighted x, three L-vectors) and chunk scan (C
    and B transposed, B's room reused for h_prev, the gated L x L matrix,
    x and three L-vectors)."""
    L = KERNEL_CHUNK
    states = L * N + L * P + 3 * L
    scan = N * L + max(N * L, N * P) + L * L + L * P + 3 * L
    return 4 * max(states, scan)


def scratch_bytes(B: int, S: int, H: int, P: int, N: int) -> int:
    """Device scratch of one call: the f32 per-chunk states (B, n_chunks,
    H, N, P) and each chunk's last cumsum (B, n_chunks, H)."""
    nc = -(-S // KERNEL_CHUNK)
    return 4 * B * nc * H * (N * P + 1)


def _check(x, dt, A, Bm, Cm, chunk):
    if torch.is_grad_enabled() and any(a.requires_grad
                                       for a in (x, dt, A, Bm, Cm)):
        raise RuntimeError(
            "the kernel has no backward (nor has the JAX package's Pallas "
            "kernel): call it without gradients, or train on the plain "
            "path (use_kernels=False)")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P): {tuple(x.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1] if Bm.dim() == 3 else -1
    want = {"dt": (dt, (B, S, H)), "A": (A, (H,)), "Bm": (Bm, (B, S, N)),
            "Cm": (Cm, (B, S, N))}
    for name, (a, shape) in want.items():
        if tuple(a.shape) != shape or N < 1:
            raise ValueError(f"{name} must be {shape}: {tuple(a.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16: {x.dtype}")
    for name, a, dtype in (("dt", dt, torch.float32),
                           ("A", A, torch.float32), ("Bm", Bm, x.dtype),
                           ("Cm", Cm, x.dtype)):
        if a.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}: {a.dtype}")
    for name, a in (("x", x), *((n, a) for n, (a, _) in want.items())):
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    L = min(chunk, S)
    if L < 1 or S % L:
        raise ValueError(f"S={S} must be a multiple of the chunk {L}")
    if x.device.type == "cuda" and (N % 4 or P % 4 or P > MAX_P):
        raise ValueError(f"the kernel takes N and P in multiples of 4, "
                         f"P <= {MAX_P}: N={N}, P={P}")
    if smem_bytes(N, P) > MAX_SMEM_BYTES:
        raise ValueError(f"N={N}, P={P} needs {smem_bytes(N, P)} B of "
                         f"shared memory; a Hopper block has "
                         f"{MAX_SMEM_BYTES}")


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,N) -> (y (B,S,H,P),
    final_state (B,H,P,N) f32).

    CUDA tensors launch the kernel; CPU tensors run the plain version;
    meta tensors get the outputs' shapes (`ssd_scan_op`).
    """
    _check(x, dt, A, Bm, Cm, chunk)
    return ssd_scan_op(x, dt, A, Bm, Cm, int(chunk))


ssd_scan.launches = 0


# ---------------------------------------------------------------------------
# The launch as a custom op: a kernel a device
# ---------------------------------------------------------------------------
@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=(),
                         device_types="cpu")
def ssd_scan_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor,
                chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The wrapper's launch (validated inputs): the plain version on the
    CPU, the kernels on the card (`_launch`), the outputs' shapes on meta
    (`_fake`).  A dispatch mode sees the call as one op
    (`launch.hlo_analysis` counts it with `op_count`'s formula)."""
    return ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)


@ssd_scan_op.register_kernel("cuda")
def _launch(x, dt, A, Bm, Cm, chunk):
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = -(-S // KERNEL_CHUNK)
    y = torch.empty_like(x)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    states = torch.empty((B, nc, H, N, P), dtype=torch.float32,
                         device=x.device)
    cum_last = torch.empty((B, nc, H), dtype=torch.float32, device=x.device)
    err = _lib()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), y.data_ptr(), h.data_ptr(),
                 states.data_ptr(), cum_last.data_ptr(), B, S, H, P, N,
                 int(x.dtype == torch.bfloat16),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
    ssd_scan.launches += 1
    return y, h


@ssd_scan_op.register_fake
def _fake(x, dt, A, Bm, Cm, chunk):
    B, S, H, P = x.shape
    return (torch.empty_like(x),
            x.new_empty((B, H, P, Bm.shape[-1]), dtype=torch.float32))


def op_count(B, S, H, P, N, elem=2) -> tuple:
    """(flops, bytes) of one launch at the kernel's own chunk L: per
    chunk and head, the causal half of C B^T (N each) and of the intra
    product (P each), C state and B^T x (N P each); x, Bm, Cm (`elem`
    bytes an element), dt and A (f32) read once, y and the final f32
    state written once."""
    L = KERNEL_CHUNK
    tri = L * (L + 1) // 2
    flops = B * H * (-(-S // L)) * 2 * (tri * N + tri * P + 2 * L * N * P)
    n_bytes = (elem * (2 * B * S * H * P + 2 * B * S * N) + 4 * B * S * H
               + 4 * H + 4 * B * H * P * N)
    return flops, n_bytes


@register_flop_formula(torch.ops.repro_torch.ssd_scan)
def _flops(x_shape, dt_shape, A_shape, Bm_shape, Cm_shape, chunk, *,
           out_shape=None, **kwargs) -> int:
    B, S, H, P = x_shape
    return op_count(B, S, H, P, Bm_shape[-1])[0]


# ---------------------------------------------------------------------------
# The plain PyTorch version (CPU path of the wrapper; the card's oracle)
# ---------------------------------------------------------------------------
def ssd_scan_plain(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """The kernel's function: the chunked SSD algorithm in f32 (as the TPU
    kernel computes it), y cast to x's dtype once."""
    from repro_torch.models.mamba2 import ssd_chunked
    y, h = ssd_chunked(x.float(), dt.float(), A.float(), Bm.float(),
                       Cm.float(), chunk)
    return y.to(x.dtype), h
