"""The gmm_estep kernels against a parent checkout: the wide path at Table
II's and Fig. 13's node shapes and those two experiments on the fused
backend, and the shared-memory path at the deployment size.

    python3 tools/gmm_wide_vs_parent.py [--only wide|shared] ROOT [ROOT ...]

Run on a machine with a CUDA card.  Each ROOT is a checkout of the repo
(e.g. a parent commit unpacked with `git archive` into a git-ignored
directory); each runs in its own process, in the order given, so
`parent . . parent` shows the drift between runs beside the difference.
Per root it prints one JSON line:
* node_shapes_ms (wide): the call's device time at each of chip_smoke.py's
  WIDE_CASES node shapes, f32 x, return_r=False, without and with a shift
  (the engine's call), from 20 calls captured in one CUDA graph and
  replayed five times (chip_smoke.py's graph_time_ms), and the device
  time a call of each kernel the call launches (torch.profiler, 20 calls
  with a shift);
* sec5 (wide): Table II and Fig. 13 on the fused backend at
  chip_smoke.py's cut iteration counts, each run twice: the second run's
  host seconds, its derived string and the wide path's launches
  (gmm_estep_nodes.launches counts one a call);
* shared_ms (shared): the shared path's time a call at chip_smoke.py's
  SMEM_TIMED shapes (1000 sensors x 4096 points; K=32/D=3, K=8/D=2,
  K=4/D=8), f32 x, with a shift, return_r=False, by CUDA events over 20
  calls after one warm-up (chip_smoke.py's time_ms), with the statistics'
  largest difference from the first root's at the same inputs.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

# chip_smoke.py's WIDE_CASES (nodes, points a node, K, D) and its
# SEC5_MAX_ITERS for the two experiments that run the wide path
WIDE_CASES = ((20, 17, 2, 34), (10, 14, 2, 52), (10, 28, 4, 52),
              (10, 43, 6, 52))
SEC5 = (("table2_ionosphere", 100), ("fig13_coil20", 60))
# chip_smoke.py's SMEM_TIMED (nodes, points a node, K, D)
SMEM_TIMED = ((1000, 4096, 32, 3), (1000, 4096, 8, 2), (1000, 4096, 4, 8))


def graph_time_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def time_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _terms(rng, N, K, D, dev):
    import numpy as np
    import torch
    A = rng.normal(size=(N, K, D, D)) * 0.3
    return [torch.tensor(t, dtype=torch.float32, device=dev) for t in (
        rng.normal(size=(N, K)),
        np.einsum("nkij,nklj->nkil", A, A) + np.eye(D),
        rng.normal(size=(N, K, D)), rng.uniform(1, 3, (N, K)))]


def shared_worker(dev) -> list:
    """The shared path at SMEM_TIMED; the statistics go to a file beside
    the report so that later roots can be compared with the first."""
    import numpy as np
    import torch

    from repro_torch.kernels import gmm_estep, ops
    rows = []
    for N, T, K, D in SMEM_TIMED:
        assert gmm_estep.kernel_variant(K, D) == "shared"
        gen = torch.Generator(dev).manual_seed(17)
        x = torch.randn(N, T, D, generator=gen, device=dev) * 2
        mask = (torch.rand(N, T, generator=gen, device=dev) > 0.1).float()
        terms = _terms(np.random.default_rng(17), N, K, D, dev)
        shift = torch.randn(N, K, D, generator=gen, device=dev)

        def call():
            return ops.gmm_estep_nodes(x, mask, *terms, shift=shift,
                                       return_r=False)

        stats = torch.cat([s.reshape(N, -1) for s in call()[1:]], 1).cpu()
        rows.append({"shape": [N, T, K, D], "ms": time_ms(call, 20),
                     "stats": stats})
        del x, mask, terms, shift
        torch.cuda.empty_cache()
    return rows


def worker(root: str, only: str) -> dict:
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    import numpy as np
    import torch

    from repro_torch.experiments import paper_figures
    from repro_torch.kernels import gmm_estep, ops

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"root": root}
    if only in ("shared", "all"):
        out["shared_ms"] = shared_worker(dev)
    if only == "shared":
        return out
    rng = np.random.default_rng(15)
    node = []
    for N, T, K, D in WIDE_CASES:
        x = torch.tensor(rng.normal(size=(N, T, D)) * 2, dtype=torch.float32,
                         device=dev)
        mask = torch.ones(N, T, device=dev)
        terms = _terms(rng, N, K, D, dev)
        shift = torch.tensor(rng.normal(size=(N, K, D)), dtype=torch.float32,
                             device=dev)
        assert gmm_estep.kernel_variant(K, D) == "wide"

        def call(s):
            return ops.gmm_estep_nodes(x, mask, *terms, 3.0, shift=s,
                                       return_r=False)

        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                call(shift)
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.key_averages():
            us = getattr(e, "device_time_total",
                         getattr(e, "cuda_time_total", 0.0))
            if us > 0 and not getattr(e, "is_user_annotation", False):
                kernels[e.key[:60]] = us / 20 / 1e3
        node.append({"shape": [N, T, K, D],
                     "ms": graph_time_ms(lambda: call(None), 20),
                     "ms_shift": graph_time_ms(lambda: call(shift), 20),
                     "kernels_ms_a_call": kernels})
    sec5 = {}
    fns = {fn.__name__: fn for fn in paper_figures.ALL}
    for name, iters in SEC5:
        for _ in range(2):
            before = gmm_estep.gmm_estep_nodes.launches
            t0 = time.perf_counter()
            (_, us, derived), = fns[name](False, backend="fused", device=dev,
                                          max_iters=iters, results={})
            torch.cuda.synchronize()
            sec5[name] = {"seconds": time.perf_counter() - t0,
                          "us_per_iter_last_run": us, "derived": derived,
                          "wide_launches":
                              gmm_estep.gmm_estep_nodes.launches - before}
    out.update(node_shapes_ms=node, sec5=sec5)
    return out


def main(argv) -> int:
    if argv[:1] == ["--worker"]:
        import torch
        out = worker(argv[1], argv[2])
        first = argv[3]
        for row in out.get("shared_ms", []):
            stats = row.pop("stats")
            path = f"{first}.{'x'.join(map(str, row['shape']))}.pt"
            if not os.path.exists(path):
                torch.save(stats, path)
            row["max_abs_diff_vs_first_root"] = float(
                (stats - torch.load(path)).abs().max())
        print(json.dumps(out), flush=True)
        return 0
    only = "all"
    if argv[:1] == ["--only"]:
        only, argv = argv[1], argv[2:]
    if not argv or only not in ("all", "wide", "shared"):
        raise SystemExit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    # the first root's shared-path statistics, under the (git-ignored)
    # build directory of this checkout
    tmp = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "build", "gmm_vs_parent")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    first = os.path.join(tmp, "first")
    rc = 0
    for root in argv:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", root, only, first]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
