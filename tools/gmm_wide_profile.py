"""Phase profile of the wide gmm_estep path on the card.

    python3 tools/gmm_wide_profile.py

Run from the repository root on a machine with a CUDA card.  It writes an
instrumented copy of csrc/gmm_estep.cu to build/gmm_wide_profile/: after
each of the source lines in MARKS, thread 0 of each block adds the clock
cycles since the last mark to a device counter.  The copy is compiled with
nvcc directly (the package's own build is untouched) and launched through
its C entry point, at chip_smoke.py's deployment shape (1000 sensors x
4096 points, K=2, D=34, f32 and bf16 x) and at K=1 / K=4 (D=34) and K=2
(D=52).  It prints one JSON line per shape: the call's device time (CUDA
events, with the profile's atomics in it) and the mean cycles a tile of
each phase, as thread 0 (warp 0) sees it: wait (its copies of the tile),
barrier_a (every copy in, the last tile done), convert (x to the f64
tile, with the barrier after it), issue (the next tile's copies), quad
(the quadratic form), barrier_quad (the barrier after it), softmax (with
the barrier before the statistics), stats (the statistics).
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import build, gmm_estep  # noqa: E402

PHASES = ("wait", "barrier_a", "convert", "issue", "quad", "barrier_quad",
          "softmax", "stats")
# the wide kernel's tile loop: the clock starts after the first line, and
# phase i ends after line i + 1 (each must occur once in the source)
MARKS = ("if (ntiles > 0) issue(0);",
         "if (tid < tp) s_m[tid] = m_reg;",
         "__syncthreads();   // the raw tile is in; the last tile is done",
         "__syncthreads();   // the f64 tile is in; its raw buffer is free",
         "if (i + 1 < ntiles) issue(i + 1);",
         "wide_quad<Tin, XG>(P, X, Ub, B.nkb, s_q, warp, lane);",
         "__syncthreads();   // q of every point and component is in",
         "__syncthreads();   // r is in",
         "if constexpr (XG) __syncthreads();   // s_q is free for the next "
         "tile")
HEAD = r"""
__device__ unsigned long long g_wprof[8];
#define WPROF_START long long _t = clock64();
#define WPROF(i)                                                  \
  if (tid == 0) {                                                 \
    const long long _c = clock64();                               \
    atomicAdd(&g_wprof[i], (unsigned long long)(_c - _t));        \
    _t = _c;                                                      \
  }
"""
TAIL = r"""
// the counters (cycles of thread 0 summed over blocks and tiles); reset = 1
// zeroes them after the read
extern "C" int gmm_estep_wide_prof(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_wprof, sizeof(g_wprof));
  if (e == cudaSuccess && reset) {
    const unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    e = cudaMemcpyToSymbol(g_wprof, z, sizeof(z));
  }
  return (int)e;
}
"""
SHAPES = ((1000, 4096, 2, 34, torch.float32),
          (1000, 4096, 2, 34, torch.bfloat16),
          (1000, 4096, 1, 34, torch.float32),
          (1000, 4096, 4, 34, torch.float32),
          (500, 4096, 2, 52, torch.float32))


def instrumented_source() -> str:
    """csrc/gmm_estep.cu with the counters and a mark after each line of
    MARKS."""
    lines = (build.CSRC / "gmm_estep.cu").read_text().split("\n")
    for i, mark in enumerate(MARKS):
        at = [j for j, ln in enumerate(lines) if ln.strip() == mark]
        if len(at) != 1:
            raise RuntimeError(f"{len(at)} lines of csrc/gmm_estep.cu read "
                               f"{mark!r}; the profile needs exactly one")
        pad = lines[at[0]][:len(lines[at[0]]) - len(lines[at[0]].lstrip())]
        lines.insert(at[0] + 1,
                     pad + ("WPROF_START" if i == 0 else f"WPROF({i - 1})"))
    src = "\n".join(lines)
    inc = src.index("#include <stdint.h>\n") + len("#include <stdint.h>\n")
    return src[:inc] + HEAD + src[inc:] + TAIL


def load_profiled():
    """Compile the instrumented copy; returns (its library, its bound
    launch entry)."""
    out = os.path.join(ROOT, "build", "gmm_wide_profile")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, "gmm_estep_prof.cu")
    with open(src, "w") as f:
        f.write(instrumented_source())
    so = os.path.join(out, "libgmm_estep_prof.so")
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I",
                           str(build.CSRC), "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the instrumented copy:\n"
                           f"{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(so)
    return lib, gmm_estep._bind(lib)


def launch(fn, x, mask, terms, shift):
    """One wide-path call through the instrumented library's entry point,
    with the arguments gmm_estep._launch gives it (return_r=False)."""
    N, T, D = x.shape
    K = terms[0].shape[1]
    stats = torch.empty((N, K + K * D + K, D), device=x.device)
    work = torch.empty(gmm_estep.wide_workspace_bytes(N, T, K, D,
                                                      x.element_size()),
                       dtype=torch.uint8, device=x.device)
    err = fn(x.data_ptr(), mask.data_ptr(), *(t.data_ptr() for t in terms),
             shift.data_ptr(), None, stats.data_ptr(), N, T, K, D,
             gmm_estep.DEFAULT_BLOCK_T, 1.0, int(x.dtype == torch.bfloat16),
             0, 2, 0, torch.cuda.current_stream().cuda_stream,
             work.data_ptr())
    if err != 0:
        raise RuntimeError(f"the profiled launch failed: cudaError {err}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("gmm_wide_profile: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    lib, fn = load_profiled()
    counters = (ctypes.c_ulonglong * 8)()
    dev = torch.device("cuda")
    for N, T, K, D, dtype in SHAPES:
        assert gmm_estep.kernel_variant(K, D) == "wide"
        rng = np.random.default_rng(3)
        gen = torch.Generator(dev).manual_seed(3)
        x = (torch.randn(N, T, D, generator=gen, device=dev) * 2).to(dtype)
        mask = (torch.rand(N, T, generator=gen, device=dev) > 0.1).to(dtype)
        A = rng.normal(size=(N, K, D, D)) * 0.3
        terms = [torch.tensor(v, dtype=torch.float32, device=dev) for v in (
            rng.normal(size=(N, K)), np.einsum("nkij,nklj->nkil", A, A)
            + np.eye(D), rng.normal(size=(N, K, D)),
            rng.uniform(1, 3, (N, K)))]
        shift = torch.randn(N, K, D, generator=gen, device=dev)
        launch(fn, x, mask, terms, shift)
        torch.cuda.synchronize()
        lib.gmm_estep_wide_prof(counters, 1)
        reps = 3
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            launch(fn, x, mask, terms, shift)
        end.record()
        torch.cuda.synchronize()
        if lib.gmm_estep_wide_prof(counters, 1) != 0:
            raise RuntimeError("reading the profile counters failed")
        plan = gmm_estep.wide_plan(K, D, x.element_size())
        tiles = N * -(-T // plan["tp"]) * reps
        print(json.dumps({
            "shape": [N, T, K, D], "x": str(dtype)[6:],
            "ms_profiled": start.elapsed_time(end) / reps,
            "cycles_a_tile": {p: counters[i] / tiles
                              for i, p in enumerate(PHASES)},
            "plan": {k: plan[k] for k in ("tp", "nby", "kb", "su")}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
