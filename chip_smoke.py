"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card (an H100 for
the numbers in PERF.md).  It imports only the port (`src/repro_torch`),
never JAX or the JAX package, and prints one JSON line per phase:

1. device — the card, its power limit (nvidia-smi), the TF32 switches
   (both set off);
2. build — compiles every kernel from src/repro_torch/csrc with nvcc and
   reports the build seconds and ptxas's registers/shared memory/spills;
3. kernel_vs_plain — gmm_estep_nodes against its plain PyTorch version on
   the card, at the tests/test_kernels.py sweep shapes, K=4/D=2, K=8/D=1,
   K=8/D=2, K=32/D=3 and the main path's shape (f32 and bf16 x), with
   ragged masks, r on and off and a replication factor, each case naming
   the kernel variant (register or shared-memory path) it ran and the
   worst share of its tolerance an element used; plus bit-equality under
   trailing zero padding and across two launches on both paths;
4. main_path — the paper's five estimators through algorithms.run_* with
   backend="fused" at N=1000 sensors x 4096 points (K=3, D=2): finite
   results, one kernel launch per iteration, cVB and dSVB matched against
   backend="reference", ms per iteration, the kernel's time against its
   bound for f32 and bf16 x (the first design's recorded time beside
   it), its ptxas registers and spills, peak device memory, and
   (reported only) what cVB gives with f32 iterates instead of the main
   path's f64 ones;
4a. smem_path — an over-complete mixture (K=8 on the main path's K=3
   data, dSVB, 20 iterations) through the kernel's shared-memory path:
   one launch an iteration, fused vs reference; the shared path timed at
   K=32/D=3 (f32 and bf16 x), K=8/D=2 and K=4/D=8 on 1000 x 4096 points
   against its bound, each against the plain version and the f64
   evaluation on its first nodes; bit-equality under padding and across
   launches; K=221/D=8 and K=600/D=3 once against f64;
5. small_vs_cpu — the same five estimators on a small instance, card
   (fused kernel) against CPU (plain version);
6. profile — device-busy time by kernel over ten fused dSVB iterations
   against the host wall clock, and device kernels per iteration
   (torch.profiler);
6a. gmm_wide_kernel_vs_plain — the wide-D kernel (D > 8) against the
   plain version at Table II's (20 x 17, K=2, D=34) and Fig. 13's (10 x
   14-43, K=2/4/6, D=52) node shapes and past the first wide design's
   limit (K=13/16 at D=64, K=2 at D=110, K=227 at D=8), f32 and bf16 x,
   with and without a shift, r on and off (tests/test_kernels.py's bars
   against an f64 evaluation of the same inputs; the share of those bars
   against the f32 plain version beside it), the call's device time at
   the node shapes, bit-equality under padding and across launches, and a
   deployment shape (1000 sensors x 4096 points, K=2, D=34) timed by CUDA
   events against its bound (the first wide design's recorded time
   beside it);
6b. engine_remainder — at the main path's size, fused, f64 iterates: dSVB
   on RingDiffusion, dSVB on Diffusion with link_drop=0.2, dVB-ADMM with
   adaptive_rho, and with adaptive_rho + per_block + link_drop=0.2: ms
   per iteration, one kernel launch per iteration, the Eq. 46 trajectory
   against backend="reference" at rtol/atol 1e-4, the last
   ConsensusDiagnostics;
6c. paper_sec5 — every Sec. V figure and table of
   repro_torch.experiments.paper_figures at its reduced size (each run
   cut to SEC5_MAX_ITERS iterations), fused and reference backends on
   the card: the derived strings beside BENCH_engine.json's rows, the two
   backends' agreement, the wide kernel's launches (Table II, Fig. 13);
6d. stream_main_path — streaming dSVB at the main path's size (N=1000 x
   4096, B=512, 200 iterations), plain and SVRG, fused and reference:
   ms per iteration, gmm_estep launches (one an iteration; SVRG two, plus
   one per anchor), fused vs reference at rtol/atol 1e-4, the final KL
   against the full-batch run's, B = 4096 bit-equal to the full-batch
   run, the kernel on the (1000, 512, 2) gather against its bound;
6e. stream_cpu_vs_card — a small streaming run with link_drop=0.2 on the
   CPU and the card: equal masks and index sets, trajectories to 1e-9;
6f. stream_scaled_mask_kernel — gmm_estep on masks scaled T/B (8, 40.96,
   5), f32 and bf16, register, shared and wide paths, against the plain
   version per unit of weight;
6g. streaming_experiments — repro_torch.experiments.streaming (the
   minibatch and SVRG benchmarks, 50 x 100, B=20) with their bars;
6h. model_zoo — HMM (1000 sensors x 8 chains x 64 steps) and PPCA (1000
   x 4096, D=6, Q=2) through dSVB and dVB-ADMM: ms and device kernels per
   iteration, the samplers' host seconds, backend="fused" warning and
   equal to the reference backend (the one fallback);
6i. sparse_main_path — the paper's experiment at N=100,000 sensors x 4096
   points (K=3, D=2, f32 data, f64 iterates) over
   `random_geometric_edges(100000)` (its build seconds, under 30 s):
   sparse dSVB, nsg-dVB and adaptive dVB-ADMM through algorithms.run_*,
   RingDiffusion over the ring's edge list with link_drop=0.2,
   PairwiseGossip (p=0.3) and HierarchicalFusion, 20 fused iterations
   each: ms per iteration, one gmm_estep launch an iteration, the final
   KL, device kernels per iteration, each case's peak memory beside the
   data's bytes and the 80 GB a dense f64 matrix would need (what is
   held at the window's start, by tensor, and the allocations live at
   each case's transient peak, by source line), and every operator's
   shapes over one iteration with no tensor of two dimensions >= N;
   then gmm_estep_nodes at 100,000 x 4096 on the terms of the sparse
   dSVB run's iterate against its plain version (a chunk of nodes at a
   time) at the TOL bars, and sparse dSVB's first 3 KLs against the
   reference backend's (a chunk of nodes at a time) at rtol/atol 1e-4;
6j. sparse_vs_dense_card — at 10,000 x 4096: one combine sparse against
   dense (Diffusion, with link drops, the ring, ADMM's neighbour sum) at
   1e-12 relative; 20 sparse dSVB and adaptive ADMM iterations fused
   against reference at rtol/atol 1e-4; the combines launched twice
   bit-equal; a sparse session on the CPU and the card (1000 nodes)
   within 1e-12 after one iteration, the same coins;
6k. session_checkpoint — save at t=5, restore, continue 5: bit-equal to
   the uninterrupted card run for sparse diffusion with link drops,
   gossip, the hierarchy, adaptive ADMM with drops and a streaming SVRG
   session; a card checkpoint continued on the CPU within 1e-9; the
   checkpoints under build/chip_smoke_ckpt/ and `latest_step`;
6l. topology_scale — repro_torch.experiments.topology_scale --full (N =
   50, 1000, 10000 at 20 points) on the card, each row beside
   BENCH_engine.json's (JAX on a CPU: the KL strings are the comparison);
6m. vb_serve_fleet — multi-tenant serving through `VBService` at the
   main path's size (1000 sensors x 4096 points a tenant, K=3, D=2, f32
   data, f64 iterates, fused, `max_fleet=8`, 25-iteration slices, pow2
   buckets): A 12 Diffusion tenants (two taus, capacities 2600/3300/4096
   on rung 4096, budgets 50/100/200, 4 arriving at slice 2 behind a
   full fleet), B 4 adaptive dVB-ADMM tenants with different rho, C 4
   RingDiffusion tenants with link_drop 0.2, D 4 streaming SVRG tenants
   (B = 512); data made once per seed (12 seeds; B-D reuse seeds 0-3).
   Per group: sessions/s, ms per fleet iteration, gmm_estep launches per
   fleet iteration (exactly 1 for A-C), the fleet shapes stepped
   (`compiles`, 1), every tenant against a solo vb_run of its budget on
   the card (C bit-equal, A/B/D within 1e-9 relative) and the same run
   in 10-iteration slices (bit-equal); device kernels per fleet
   iteration at 1, 4 and 8 occupied slots (profiled); gmm_estep_nodes
   at the fleet's 8000 x 4096 against its plain version by chunks (TOL)
   and its device time against its bound; peak memory;
7. lm_kernel_vs_plain — flash_attention and ssd_scan against their plain
   versions (and flash against scaled_dot_product_attention) at the
   tests/test_kernels.py shapes, a ragged S = 1000, the causality case and
   the full-width prefill shapes (bf16 flash runs the tensor-core kernel,
   f32 the CUDA-core one); two launches on the same inputs bit-identical;
8. lm_serve_yi_6b / lm_serve_mamba2_370m — the LM serving path
   (Engine.generate with the kernels) for the published configs at full
   width and depth in bf16: 4 requests of 2048-token prompts, 32 greedy
   tokens; one kernel launch per layer; the last-position logits against
   the non-kernel path; at depth 4 in f32, logits at rtol 1e-3 and the
   first 8 greedy tokens equal; prefill ms, ms per decode step, tokens/s,
   the kernel's ms against its bound and the library's (with its
   TFLOP/s or GB/s and PR 12's time beside it), the port's own device
   kernels by name in the prefill profile, peak memory;

then the kernels line, the card's name and power limit and, last,
{"ok": true, "device": {...}}.  Each path runs with every launch count set
to 0 just before it and read just after.  Any failure raises and exits
non-zero before the last line.  Without a card it fails at once.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.gmm_sensor import GMMSensorConfig  # noqa: E402
from repro_torch.core import algorithms, expfam, gmm, network  # noqa: E402
from repro_torch.core import backends as backends_lib  # noqa: E402
from repro_torch.core import engine as vb_engine  # noqa: E402
from repro_torch.core import refperm  # noqa: E402
from repro_torch.core.engine import kl_to_reference  # noqa: E402
from repro_torch.core.model import GMMModel  # noqa: E402
from repro_torch.data import stream as stream_lib  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.experiments import paper_figures, streaming  # noqa: E402
from repro_torch.experiments import topology_scale  # noqa: E402
from repro_torch.kernels import build, gmm_estep, ops  # noqa: E402
from repro_torch.kernels import flash_attention, ssd_scan  # noqa: E402
from repro_torch.models import hmm, mamba2, ppca  # noqa: E402
from repro_torch.models import model as lm_model  # noqa: E402
from repro_torch.serving import admission, engine  # noqa: E402
from repro_torch.serving import vb_service  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, f32 outside the
# tensor cores, bf16 on the tensor cores (dense), f64 on the tensor cores
# (DMMA, the wide gmm_estep path's log rho and statistics)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_F64_TC_FLOP_PER_S = 67e12

KERNELS = ("gmm_estep", "flash_attention", "ssd_scan")

# The main path: the paper's experiment at deployment size (ISSUE/PERF.md)
N_NODES, N_PER_NODE, SEED = 1000, 4096, 0
ITERS = {"cvb": 50, "noncoop": 50, "nsg_dvb": 50, "dsvb": 200,
         "dvb_admm": 200}
# tests/test_kernels.py tolerances: r, R, sum_x, sum_xx
TOL = {"r": (0.0, 2e-5), "R": (1e-4, 1e-4), "sum_x": (1e-4, 5e-4),
       "sum_xx": (1e-3, 5e-3)}


def zero_launches():
    """Set every kernel's launch count to 0 (just before a path runs)."""
    for fn in (ops.gmm_estep_nodes, ops.flash_attention, ops.ssd_scan):
        fn.launches = 0
    for variant in ops.gmm_estep_nodes.variant_launches:
        ops.gmm_estep_nodes.variant_launches[variant] = 0


def read_launches() -> dict:
    return {"gmm_estep_nodes": ops.gmm_estep_nodes.launches,
            "flash_attention": ops.flash_attention.launches,
            "ssd_scan": ops.ssd_scan.launches}


def read_gmm_variant_launches() -> dict:
    """gmm_estep_nodes' launches by kernel (register, shared, wide path)."""
    return dict(ops.gmm_estep_nodes.variant_launches)


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` calls, by CUDA events (one
    warm-up call first)."""
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


def graph_time_ms(fn, reps: int) -> float:
    """Device time per call of fn() with the host out of the way: `reps`
    calls captured in one CUDA graph, replayed and timed by CUDA events."""
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


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------
def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False); this script runs only "
                         "on a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, **info,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return {"info": info, "smi": smi}


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------
def _ptxas_table(report: str) -> list:
    """ptxas -v's registers / spills / shared memory per kernel instance
    (gmm_estep_regs_kernel<D, x dtype>, gmm_estep_smem_kernel<D, x dtype,
    component blocks a warp holds>,
    gmm_estep_wide_kernel<x dtype, mode, x from global>, its prep and
    emit kernels, flash_wgmma_kernel<hd> (bf16),
    flash_simt_kernel<hd, f32>, ssd_states_kernel<dtype>, ssd_pass_kernel,
    ssd_chunk_scan_kernel<dtype>)."""
    rows, cur = [], None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '.*?\d+((?:gmm_estep_regs|"
                      r"gmm_estep_smem|gmm_estep_wide_prep|"
                      r"gmm_estep_wide_emit|gmm_estep_wide|flash_wgmma|"
                      r"flash_simt|ssd_states|"
                      r"ssd_pass|"
                      r"ssd_chunk_scan)_kernel)(I?)([^']*)'", ln)
        if m:
            cur = {"kernel": m.group(1)}
            if m.group(2):
                cur["x"] = "bf16" if "bfloat16" in m.group(3) else "f32"
                dim = re.match(r"Li(\d+)E", m.group(3))
                if dim:
                    cur["D" if m.group(1).startswith("gmm") else "hd"] = int(
                        dim.group(1))
                cbm = re.match(r"Li\d+E(?:f|13__nv_bfloat16)Li(\d+)E",
                               m.group(3))
                if m.group(1) == "gmm_estep_smem_kernel" and cbm:
                    cur["cbm"] = int(cbm.group(1))
                mode = re.search(r"Li(\d)ELb(\d)E", m.group(3))
                if m.group(1) == "gmm_estep_wide_kernel" and mode:
                    cur["mode"] = ("fused", "lse", "split")[int(mode.group(1))]
                    cur["x_from_global"] = mode.group(2) == "1"
            rows.append(cur)
        elif cur is not None:
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("static_smem", r"(\d+) bytes smem")):
                m = re.search(pat, ln)
                if m:
                    cur[key] = int(m.group(1))
    return rows


def phase_build() -> dict:
    """Every kernel from its source: one nvcc process each, all started
    together.  Returns {kernel: ptxas table}."""
    t0 = time.perf_counter()
    built = build.build_all(KERNELS, force=True)
    wall = time.perf_counter() - t0
    tables = {name: _ptxas_table(built[name].report) for name in KERNELS}
    for name in KERNELS:
        emit("build", kernel=name, seconds=round(built[name].seconds, 3),
             library=os.path.relpath(built[name].path, HERE),
             ptxas=tables[name])
    emit("build_all", kernels=list(KERNELS), wall_seconds=round(wall, 3))
    # the wide and shared paths' instances: none spills (at up to 255
    # registers a thread small edits have tipped them into spills)
    wide = [r for r in tables["gmm_estep"]
            if r["kernel"].startswith("gmm_estep_wide")]
    if not wide or any(r.get("spill_stores", 0) or r.get("spill_loads", 0)
                       for r in wide):
        raise AssertionError(f"the wide gmm_estep kernels spill (or were "
                             f"not found): {wide}")
    shared = [r for r in tables["gmm_estep"]
              if r["kernel"] == "gmm_estep_smem_kernel"]
    want = {(D, x, cbm) for D in range(1, gmm_estep.MAX_D + 1)
            for x in ("f32", "bf16") for cbm in (1, gmm_estep.shared_cbmax(D))}
    if ({(r.get("D"), r.get("x"), r.get("cbm")) for r in shared} != want
            or any(r.get("spill_stores", 0) or r.get("spill_loads", 0)
                   for r in shared)):
        raise AssertionError(f"the shared gmm_estep kernels spill (or an "
                             f"instance was not found): {shared}")
    return tables


# ---------------------------------------------------------------------------
# 3. kernel vs plain version
# ---------------------------------------------------------------------------
def _random_terms(N, K, D, dev, rng):
    A = rng.normal(size=(N, K, D, D)) * 0.3
    terms = (rng.normal(size=(N, K)),
             np.einsum("nkij,nklj->nkil", A, A) + np.eye(D),
             rng.normal(size=(N, K, D)), rng.uniform(1, 3, (N, K)))
    return [torch.tensor(t, dtype=torch.float32, device=dev) for t in terms]


def _compare(got, want) -> tuple:
    """Assert the tests/test_kernels.py tolerances; returns the max
    absolute error over all outputs and the worst share of its bar an
    element uses, |got - want| / (atol + rtol |want|) (at most 1)."""
    err = share = 0.0
    for name, g, w in zip(("r", "R", "sum_x", "sum_xx"), got, want):
        if g is None or w is None:
            if (g is None) != (w is None):
                raise AssertionError(f"{name}: one version returned None")
            continue
        rtol, atol = TOL[name]
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol,
                                   msg=lambda m: f"{name}: {m}")
        diff = (g - w).abs()
        err = max(err, float(diff.max()))
        share = max(share, float((diff / (atol + rtol * w.abs())).max()))
    return err, share


def phase_kernel_vs_plain(main_x, main_mask, dev):
    rng = np.random.default_rng(0)
    cases = []
    # the tests/test_kernels.py sweep shapes, the register path's widest K
    # at D = 2 and D = 1 and an unaligned T on it, K=8/D=2, then K=32/D=3
    for N, T, K, D in ((1, 100, 3, 2), (1, 257, 4, 5), (1, 64, 2, 8),
                       (1, 500, 6, 3), (3, 1000, 4, 2), (2, 777, 8, 1),
                       (2, 257, 3, 2), (3, 1000, 8, 2), (4, 300, 32, 3)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.tensor(rng.normal(size=(N, T, D)) * 2, dtype=dtype,
                             device=dev)
            mask = torch.tensor(rng.random((N, T)) > 0.2, dtype=dtype,
                                device=dev)
            terms = _random_terms(N, K, D, dev, rng)
            for return_r in (True, False):
                args = (x, mask, *terms, 3.0)
                err, share = _compare(
                    ops.gmm_estep_nodes(*args, return_r=return_r),
                    gmm_estep.gmm_estep_nodes_plain(*args,
                                                    return_r=return_r))
                cases.append({"shape": [N, T, K, D], "x": str(dtype)[6:],
                              "variant": gmm_estep.kernel_variant(K, D),
                              "return_r": return_r, "max_abs_err": err,
                              "bar_share": share})
    # the main path's shape: its data with a ragged mask (the terms as
    # the tests draw them; the engine's own terms are checked in phase 4)
    N, T = main_mask.shape
    keep = ((rng.random((N, T)) > 0.1)
            & (np.arange(T)[None] < T - rng.integers(1, 500, (N, 1))))
    ragged = main_mask * torch.tensor(keep, dtype=main_mask.dtype,
                                      device=dev)
    terms = _random_terms(N, 3, 2, dev, rng)
    shift = torch.tensor(rng.uniform(1, 6, (N, 3, 2)), dtype=torch.float32,
                         device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        x, mask = main_x.to(dtype), ragged.to(dtype)
        for return_r, s in ((True, None), (False, None), (True, shift),
                            (False, shift)):
            args = (x, mask, *terms, float(N))
            err, share = _compare(
                ops.gmm_estep_nodes(*args, shift=s, return_r=return_r),
                gmm_estep.gmm_estep_nodes_plain(*args, shift=s,
                                                return_r=return_r))
            cases.append({"shape": [N, T, 3, 2],
                          "variant": gmm_estep.kernel_variant(3, 2),
                          "x": str(dtype)[6:], "return_r": return_r,
                          "shift": s is not None, "max_abs_err": err,
                          "bar_share": share})
    # bit equality: trailing zero padding, and two launches (plain and
    # centred)
    pad_equal = repeat_equal = True
    for s in (None, shift):
        args = (main_x, ragged, *terms, float(N))
        base = ops.gmm_estep_nodes(*args, shift=s, return_r=False)
        again = ops.gmm_estep_nodes(*args, shift=s, return_r=False)
        padded = ops.gmm_estep_nodes(
            torch.cat([main_x, main_x.new_zeros(N, 1000, 2)], 1),
            torch.cat([ragged, ragged.new_zeros(N, 1000)], 1),
            *terms, float(N), shift=s, return_r=False)
        pad_equal &= all(torch.equal(a, b)
                         for a, b in zip(base[1:], padded[1:]))
        repeat_equal &= all(torch.equal(a, b)
                            for a, b in zip(base[1:], again[1:]))
    # the shared-memory path: K=32/D=3 at T = 1000, padded by 1, 24, 3000
    x, mask = (torch.tensor(a, dtype=torch.float32, device=dev) for a in
               (rng.normal(size=(8, 1000, 3)), rng.random((8, 1000)) > 0.2))
    terms = _random_terms(8, 32, 3, dev, rng)
    base = ops.gmm_estep_nodes(x, mask, *terms, 5.0, return_r=False)
    again = ops.gmm_estep_nodes(x, mask, *terms, 5.0, return_r=False)
    repeat_equal &= all(torch.equal(a, b)
                        for a, b in zip(base[1:], again[1:]))
    for pad in (1, 24, 3000):
        padded = ops.gmm_estep_nodes(
            torch.cat([x, x.new_zeros(8, pad, 3)], 1),
            torch.cat([mask, mask.new_zeros(8, pad)], 1), *terms, 5.0,
            return_r=False)
        pad_equal &= all(torch.equal(a, b)
                         for a, b in zip(base[1:], padded[1:]))
    torch.cuda.synchronize()
    emit("kernel_vs_plain", tolerance=TOL, cases=cases,
         worst_bar_share=max(c["bar_share"] for c in cases),
         padding_bit_equal=pad_equal, launches_bit_equal=repeat_equal)
    if not (pad_equal and repeat_equal):
        raise AssertionError("gmm_estep_nodes is not bit-invariant")


# ---------------------------------------------------------------------------
# 4. the main path at full size
# ---------------------------------------------------------------------------
def _instance(n_nodes, n_per_node, dev):
    cfg = GMMSensorConfig()
    data = synthetic.paper_synthetic(n_nodes=n_nodes, n_per_node=n_per_node,
                                     seed=SEED, dtype=np.float32)
    adj, _ = network.random_geometric_graph(n_nodes, seed=SEED)
    W = network.nearest_neighbor_weights(adj)
    # the data stream in f32; the iterates, the post-stage and the Eq. 46
    # metric run in f64: at 4.1 M points an f32 iterate cannot resolve
    # cVB's converged KL to the 1e-4 the comparison below asks (PERF.md)
    prior = expfam.noninformative_prior(
        cfg.K, cfg.D, alpha0=cfg.alpha0, beta0=cfg.beta0,
        w0_scale=cfg.w0_scale, dtype=torch.float64, device=dev)
    x, mask = data.x.to(dev), data.mask.to(dev)
    # the Eq. 46 reference: the true-label posterior (as
    # gmm.ground_truth_posterior), accumulated per node, then over nodes
    r = torch.nn.functional.one_hot(data.labels.to(dev).long(), cfg.K)
    st = gmm.sufficient_stats(x.double(), r.double() * mask.double()[
        ..., None], 1.0)
    ref_q = gmm.posterior_from_stats(
        gmm.SuffStats(*(expfam.ordered_sum(a) for a in st)), prior)
    ref = refperm.permuted_refs(ref_q)
    # the initial posterior: the prior with its means scattered over the
    # data range (the reference's _perturbed_init, drawn with numpy)
    u = np.random.default_rng(SEED).uniform(size=(cfg.K, cfg.D))
    lo, hi = x.reshape(-1, cfg.D).amin(0), x.reshape(-1, cfg.D).amax(0)
    init_q = prior._replace(m=(lo + (hi - lo) * torch.tensor(
        u, dtype=torch.float32, device=dev)).double())
    return cfg, x, mask, adj, W, prior, ref, init_q


def _estimate(name, cfg, x, mask, adj, W, prior, ref, init_q, backend,
              n_iters, dev):
    graph = {"nsg_dvb": (W,), "dsvb": (W,), "dvb_admm": (adj,)}
    kw = {"tau": cfg.tau, "d0": cfg.d0} if name == "dsvb" else {}
    if name == "dvb_admm":
        kw = {"rho": cfg.rho, "xi": cfg.xi}
    return algorithms.ALGORITHMS[name](
        x, mask, *graph.get(name, ()), prior, n_iters=n_iters, K=cfg.K,
        D=cfg.D, ref_phi=ref, init_q=init_q, backend=backend, device=dev,
        **kw)


def _gmm_bound(x, mask, terms, shift, K, D):
    """(bound ms, by, bytes, flops) of one gmm_estep_nodes call without r,
    any path: x and mask in their dtype, the f32 terms and shift read
    once, the statistics written once; per point and component the least
    work the function needs (no padding to a kernel's shapes): log rho as
    the quadratic form x'^T U_k x' of x' = (x, 1), with y.b, c and the
    centring folded into U_k once a node and component (O(D^2), left out),
    on U_k's upper triangle ((D + 1)(D + 2)) and its row dot (2 (D + 1));
    the combine and softmax (~10); the statistics r y (D), sum_x (D), the
    upper triangle of sum_xx (D (D + 1)) and R (1): 2 D^2 + 8 D + 15 in
    all.  The f64 parts are priced at the FP64 tensor cores' peak, the
    softmax at the f32 peak (both 67 TFLOP/s on the H100)."""
    N, T = mask.shape
    n_bytes = (x.numel() * x.element_size()
               + mask.numel() * mask.element_size()
               + sum(t.numel() * 4 for t in (*terms, shift))
               + N * (K + K * D + K) * D * 4)
    per = N * T * K
    f64_log_rho = per * ((D + 1) * (D + 2) + 2 * (D + 1))
    softmax = per * 10
    stats = per * (D * D + 3 * D + 1)
    flops = f64_log_rho + softmax + stats
    bound = {"bytes": n_bytes / PEAK_BYTES_PER_S * 1e3,
             "operations": ((f64_log_rho + stats) / PEAK_F64_TC_FLOP_PER_S
                            + softmax / PEAK_F32_FLOP_PER_S) * 1e3}
    by = max(bound, key=bound.get)
    return bound[by], by, n_bytes, flops


def phase_main_path(inst, dev, ptxas) -> dict:
    cfg, x, mask, adj, W, prior, ref, init_q = inst
    torch.cuda.reset_peak_memory_stats()

    # warm-up (library handles, first launches) outside the timed window
    _estimate("cvb", *inst, "fused", 2, dev)
    torch.cuda.synchronize()
    results, ms_per_iter = {}, {}
    zero_launches()                               # the main path's window
    for name, n_iters in ITERS.items():
        before = ops.gmm_estep_nodes.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = _estimate(name, *inst, "fused", n_iters, dev)
        torch.cuda.synchronize()
        ms_per_iter[name] = (time.perf_counter() - t0) * 1e3 / n_iters
        launched = ops.gmm_estep_nodes.launches - before
        finite = bool(torch.isfinite(run.phi).all()
                      and torch.isfinite(run.kl_mean).all())
        results[name] = run
        emit("main_path_run", estimator=name, backend="fused",
             n_iters=n_iters, launches=launched, finite=finite,
             ms_per_iter=ms_per_iter[name],
             kl_first=float(run.kl_mean[0]), kl_last=float(run.kl_mean[-1]))
        if not finite:
            raise AssertionError(f"{name}: non-finite result")
        if launched != n_iters:
            raise AssertionError(f"{name}: {launched} kernel launches for "
                                 f"{n_iters} iterations")
    launches = ops.gmm_estep_nodes.launches      # read just after the path
    peak = torch.cuda.max_memory_allocated()

    # the fused KL trajectory against the reference backend's
    ref_runs = {}
    for name in ("cvb", "dsvb"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref_run = ref_runs[name] = _estimate(name, *inst, "reference",
                                             ITERS[name], dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / ITERS[name]
        fused = results[name].kl_mean
        rel = float(((fused - ref_run.kl_mean).abs()
                     / ref_run.kl_mean.abs().clamp_min(1e-30)).max())
        emit("main_path_vs_reference", estimator=name,
             reference_ms_per_iter=ms, max_rel_kl_diff=rel,
             kl_last_fused=float(fused[-1]),
             kl_last_reference=float(ref_run.kl_mean[-1]))
        torch.testing.assert_close(fused, ref_run.kl_mean, rtol=1e-4,
                                   atol=1e-4)

    # the kernel alone at the main path's call (FusedBackend's): f32 x,
    # terms centred on the component means, no r
    q0 = expfam.unpack_natural(results["cvb"].phi, cfg.K, cfg.D)
    shift = q0.m.float().contiguous()
    terms = [t.contiguous() for t in gmm.estep_terms(q0, torch.float32,
                                                     shift=shift)]
    # the kernel against its plain version on the terms the engine makes,
    # unreplicated: the tolerances' absolute parts are for unscaled sums
    # (centred sums sit near zero, so replication would scale their
    # rounding past an absolute bar)
    err, share = _compare(ops.gmm_estep_nodes(x, mask, *terms, shift=shift),
                   gmm_estep.gmm_estep_nodes_plain(x, mask, *terms,
                                                   shift=shift))
    args = (x, mask, *terms, float(N_NODES))
    K, D, T = cfg.K, cfg.D, N_PER_NODE
    variant = gmm_estep.kernel_variant(K, D)
    timed = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        xd, md = x.to(dtype), mask.to(dtype)
        a = (xd, md, *terms, float(N_NODES))
        ms = graph_time_ms(lambda: ops.gmm_estep_nodes(
            *a, shift=shift, return_r=False), 20)
        bound, by, n_bytes, flops = _gmm_bound(xd, md, terms, shift, K, D)
        timed[name] = {"ms": ms, "bound_ms": bound,
                       "bound_by": by, "bytes": n_bytes, "flops": flops,
                       "fraction_of_bound": bound / ms,
                       "achieved_GBps": n_bytes / ms / 1e6}
    call_ms = time_ms(lambda: ops.gmm_estep_nodes(
        *args, shift=shift, return_r=False), 100)
    plain_ms = time_ms(lambda: gmm_estep.gmm_estep_nodes_plain(
        *args, shift=shift, return_r=False), 10)
    main = timed["f32"]
    emit("main_path_kernel", kernel="gmm_estep_nodes", variant=variant,
         max_abs_err_engine_terms=err, bar_share_engine_terms=share,
         ms=main["ms"], call_ms=call_ms,
         plain_ms=plain_ms, bound_ms=main["bound_ms"],
         bound_by=main["bound_by"], fraction_of_bound=main[
             "fraction_of_bound"], bytes=main["bytes"], flops=main["flops"],
         achieved_GBps=main["achieved_GBps"], by_dtype=timed,
         first_design_ms=FIRST_DESIGN_GMM_MS,
         ptxas=[row for row in ptxas if row["kernel"].startswith("gmm")
                and row.get("D") == D],
         max_memory_allocated=peak)
    phase_precision(inst, ref_runs["cvb"], dev)
    return {"launches": launches, "ms": main["ms"], "plain_ms": plain_ms,
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "max_abs_err": err}


def phase_precision(inst, ref_cvb, dev):
    """Why the main path's iterates are f64: cVB with f32 iterates (and so
    an f32 post-stage and metric), fused and reference, against the f64
    reference run.  Reported, not asserted."""
    cfg, x, mask, adj, W, prior, ref, init_q = inst
    mdl64 = GMMModel(prior, device=dev)
    f32 = (cfg, x, mask, adj, W, prior.to(dtype=torch.float32),
           ref.float(), init_q.to(dtype=torch.float32))
    want = float(ref_cvb.kl_mean[-1])
    out = {}
    for backend in ("fused", "reference"):
        run = _estimate("cvb", *f32, backend, ITERS["cvb"], dev)
        kl32 = float(run.kl_mean[-1])
        kl64 = float(kl_to_reference(mdl64, run.phi[:1].double(), ref)[0])
        out[backend] = {"kl_last_f32_metric": kl32,
                        "kl_last_f64_metric": kl64,
                        "rel_diff_f64_metric": abs(kl64 - want) / want}
    emit("precision_f32_iterates", estimator="cvb",
         kl_last_f64_reference=want, **out)


# ---------------------------------------------------------------------------
# 4a. an over-complete mixture on the main path's data (the shared path)
# ---------------------------------------------------------------------------
# K = 8 components on the paper's K = 3 data: a user who does not know K
# fits more components and lets VB empty the extra ones.  K (1 + D +
# D(D+1)/2) = 48 floats is past the register path's budget, so the
# kernel's shared-memory path runs it
SMEM_K, SMEM_ITERS = 8, 20
# the shared path timed at 1000 sensors x 4096 points (f32 x, a shift):
# K=32/D=3 (phase_kernel_vs_plain's case; the kernels line's), K=8/D=2
# (the over-complete run's own shape), K=4/D=8 (the widest D the path
# takes; x is 131 MB); each against the plain version and the f64
# evaluation on its first SMEM_PLAIN_NODES nodes
SMEM_TIMED = ((1000, 4096, 32, 3), (1000, 4096, 8, 2), (1000, 4096, 4, 8))
SMEM_PLAIN_NODES = 8
# run once against the f64 evaluation: the path's largest K at D = 8 and
# a large K at D = 3 (an lse pass, then passes of component blocks)
SMEM_LARGE_K = ((4, 1000, 221, 8), (4, 1000, 600, 3))
# the first shared-path design's time at SMEM_TIMED[0] (its recorded run,
# PERF.md's bring-up table; NVIDIA H100 80GB HBM3, 700 W), beside this
# run's
FIRST_DESIGN_SMEM_MS = 0.8888031959533691


def _smem_inputs(N, T, K, D, dev, seed, dtype=torch.float32):
    gen = torch.Generator(dev).manual_seed(seed)
    x = (torch.randn(N, T, D, generator=gen, device=dev) * 2).to(dtype)
    mask = (torch.rand(N, T, generator=gen, device=dev) > 0.1).to(dtype)
    terms = _random_terms(N, K, D, dev, np.random.default_rng(seed))
    shift = torch.randn(N, K, D, generator=gen, device=dev)
    return x, mask, terms, shift


def phase_smem_path(inst, dev) -> dict:
    cfg, x, mask, adj, W, prior, ref, init_q = inst
    K = SMEM_K
    if gmm_estep.kernel_variant(K, cfg.D) != "shared":
        raise AssertionError(f"K={K}, D={cfg.D} does not take the shared "
                             f"path")
    prior_k = expfam.noninformative_prior(
        K, cfg.D, alpha0=cfg.alpha0, beta0=cfg.beta0, w0_scale=cfg.w0_scale,
        dtype=torch.float64, device=dev)
    u = np.random.default_rng(SEED + 1).uniform(size=(K, cfg.D))
    lo, hi = x.reshape(-1, cfg.D).amin(0), x.reshape(-1, cfg.D).amax(0)
    init_k = prior_k._replace(m=(lo + (hi - lo) * torch.tensor(
        u, dtype=torch.float32, device=dev)).double())
    kw = dict(K=K, D=cfg.D, tau=cfg.tau, d0=cfg.d0, init_q=init_k,
              device=dev)
    algorithms.run_dsvb(x, mask, W, prior_k, n_iters=2, backend="fused",
                        **kw)                              # warm-up
    torch.cuda.synchronize()
    zero_launches()                                # this path's window
    t0 = time.perf_counter()
    run = algorithms.run_dsvb(x, mask, W, prior_k, n_iters=SMEM_ITERS,
                              backend="fused", **kw)
    torch.cuda.synchronize()
    ms_iter = (time.perf_counter() - t0) * 1e3 / SMEM_ITERS
    launches = read_gmm_variant_launches()
    ref_run = algorithms.run_dsvb(x, mask, W, prior_k, n_iters=SMEM_ITERS,
                                  backend="reference", **kw)
    rel = float(((run.phi - ref_run.phi).abs()
                 / ref_run.phi.abs().clamp_min(1e-30)).max())
    weights = expfam.unpack_natural(run.phi, K, cfg.D).alpha[0]
    torch.testing.assert_close(run.phi, ref_run.phi, rtol=1e-3, atol=1e-3)
    if launches["shared"] != SMEM_ITERS or launches["registers"] or (
            launches["wide"]):
        raise AssertionError(f"the over-complete run launched {launches}")

    # the shared path alone at SMEM_TIMED: against its plain version and
    # the f64 evaluation (first nodes), timed (CUDA events) against its
    # bound; bf16 x at the first shape
    n0 = SMEM_PLAIN_NODES
    timed = []
    for N, T, Kt, D in SMEM_TIMED:
        for dt in ((torch.float32, torch.bfloat16) if (Kt, D) == (32, 3)
                   else (torch.float32,)):
            if gmm_estep.kernel_variant(Kt, D) != "shared":
                raise AssertionError(f"K={Kt}, D={D} is not a shared shape")
            xt, mt, terms, shift = _smem_inputs(N, T, Kt, D, dev, 17, dt)
            got = ops.gmm_estep_nodes(xt, mt, *terms, shift=shift,
                                      return_r=False)
            first = (xt[:n0], mt[:n0], *(t[:n0] for t in terms))
            plain = gmm_estep.gmm_estep_nodes_plain(
                *first, shift=shift[:n0], return_r=False)
            err, share = _compare([None] + [g[:n0] for g in got[1:]], plain)
            err64, share64, _ = _compare_vs_f64(
                [None] + [g[:n0] for g in got[1:]], plain,
                gmm_estep.gmm_estep_nodes_plain(
                    *first, shift=shift[:n0], return_r=False,
                    dtype=torch.float64))
            del got
            # 100 calls: a window of 10-40 ms
            ms = time_ms(lambda: ops.gmm_estep_nodes(
                xt, mt, *terms, shift=shift, return_r=False), 100)
            bound, by, n_bytes, flops = _gmm_bound(xt, mt, terms, shift, Kt,
                                                   D)
            row = {"shape": [N, T, Kt, D], "x": str(dt)[6:], "ms": ms,
                   "bound_ms": bound, "bound_by": by, "bytes": n_bytes,
                   "flops": flops, "fraction_of_bound": bound / ms,
                   "plan": {k: gmm_estep.shared_plan(
                       Kt, D, xt.element_size())[k]
                       for k in ("cbm", "chunked", "npass", "smem")},
                   "max_abs_err_first_nodes": err, "bar_share": share,
                   "max_abs_err_vs_f64": err64, "bar_share_vs_f64": share64}
            if (Kt, D) == (32, 3) and dt == torch.float32:
                row["plain_ms"] = time_ms(
                    lambda: gmm_estep.gmm_estep_nodes_plain(
                        xt, mt, *terms, shift=shift, return_r=False), 2)
                row["first_design_ms"] = FIRST_DESIGN_SMEM_MS
            if bound / ms > 1.0:
                raise AssertionError(f"the shared kernel beat its bound: "
                                     f"{row}")
            timed.append(row)
            del xt, mt, terms, shift
            torch.cuda.empty_cache()
    # bit equality: trailing zero padding (1, 24, 3000 points) and two
    # launches, one fused shape and one that takes passes, centred
    pad_equal = repeat_equal = True
    for Kt, D in ((8, 2), (40, 3)):
        xt, mt, terms, shift = _smem_inputs(8, 1000, Kt, D, dev, 5)
        base = ops.gmm_estep_nodes(xt, mt, *terms, 5.0, shift=shift,
                                   return_r=False)
        again = ops.gmm_estep_nodes(xt, mt, *terms, 5.0, shift=shift,
                                    return_r=False)
        repeat_equal &= all(torch.equal(a, b)
                            for a, b in zip(base[1:], again[1:]))
        for pad in (1, 24, 3000):
            padded = ops.gmm_estep_nodes(
                torch.cat([xt, xt.new_zeros(8, pad, D)], 1),
                torch.cat([mt, mt.new_zeros(8, pad)], 1), *terms, 5.0,
                shift=shift, return_r=False)
            pad_equal &= all(torch.equal(a, b)
                             for a, b in zip(base[1:], padded[1:]))
    torch.cuda.synchronize()
    if not (pad_equal and repeat_equal):
        raise AssertionError("the shared gmm_estep kernel is not "
                             "bit-invariant")
    # the largest K at D = 8 and a large K at D = 3, once, against f64
    large = []
    for N, T, Kt, D in SMEM_LARGE_K:
        xt, mt, terms, shift = _smem_inputs(N, T, Kt, D, dev, 7)
        args = (xt, mt, *terms, 3.0)
        err64, share64, share_plain = _compare_vs_f64(
            ops.gmm_estep_nodes(*args, shift=shift),
            gmm_estep.gmm_estep_nodes_plain(*args, shift=shift),
            gmm_estep.gmm_estep_nodes_plain(*args, shift=shift,
                                            dtype=torch.float64))
        large.append({"shape": [N, T, Kt, D],
                      "variant": gmm_estep.kernel_variant(Kt, D),
                      "plan": {k: gmm_estep.shared_plan(Kt, D)[k]
                               for k in ("cbm", "chunked", "npass")},
                      "max_abs_err_vs_f64": err64,
                      "bar_share_vs_f64": share64,
                      "bar_share_vs_plain": share_plain})
    main = timed[0]
    emit("smem_path", estimator="dsvb", K=K, D=cfg.D, n_iters=SMEM_ITERS,
         variant="shared", launches=launches, ms_per_iter=ms_iter,
         max_rel_phi_diff_vs_reference=rel,
         component_weights_node0=weights.tolist(), tolerance=TOL,
         timed=timed, padding_bit_equal=pad_equal,
         launches_bit_equal=repeat_equal, large_k_vs_f64=large)
    torch.cuda.empty_cache()
    return {"launches": launches["shared"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "max_abs_err": max(r["max_abs_err_first_nodes"] for r in timed)}


# ---------------------------------------------------------------------------
# 5. small instance: card (kernel) against CPU (plain version)
# ---------------------------------------------------------------------------
def phase_small_vs_cpu(dev):
    cpu = torch.device("cpu")
    out = {}
    for name in ITERS:
        runs = [_estimate(name, *_instance(8, 40, d), "fused", 10, d)
                for d in (dev, cpu)]
        torch.testing.assert_close(runs[0].kl_mean.cpu(), runs[1].kl_mean,
                                   rtol=1e-4, atol=1e-4)
        out[name] = float(runs[0].kl_mean[-1])
    emit("small_vs_cpu", nodes=8, points_per_node=40, n_iters=10,
         kl_last=out)


# ---------------------------------------------------------------------------
# 6. where an iteration's time goes (torch.profiler, device activity)
# ---------------------------------------------------------------------------
def profile_window(fn, named=()) -> dict:
    """Trace fn() (then a synchronize): device-busy time by kernel against
    the host wall clock (the profiler's own overhead inflates the wall
    time, so the idle share is an upper bound).  Only device-side events
    count (kernels, copies, sets): a host op such as aten::mm reports its
    kernels' time as its own device time too, and CUPTI's "Command Buffer
    Full" marks the host waiting on a full launch queue, not device
    work.  Kernels whose name holds one of the strings in `named` are
    also listed on their own, whatever their rank."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0
              and e.key != "Command Buffer Full"]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "kernels_launched": sum(e.count for e in events),
            "top": [_kernel_row(e) for e in top],
            "named": [_kernel_row(e) for e in events
                      if any(n in e.key for n in named)]}


def _kernel_row(e) -> dict:
    return {"name": e.key[:80], "device_ms": e.self_device_time_total / 1e3,
            "count": e.count}


def phase_profile(inst, dev, n_iters: int = 10):
    """Trace `n_iters` fused dSVB iterations (`profile_window`)."""
    _estimate("dsvb", *inst, "fused", 2, dev)
    torch.cuda.synchronize()
    prof = profile_window(lambda: _estimate("dsvb", *inst, "fused", n_iters,
                                            dev), named=("gmm_estep",))
    emit("profile", estimator="dsvb", backend="fused", n_iters=n_iters,
         kernels_per_iter=prof["kernels_launched"] / n_iters,
         device_busy_ms_per_iter=prof["device_busy_ms"] / n_iters, **prof)


# ---------------------------------------------------------------------------
# 6a. the wide-D kernel (D > 8: the paper's real-data tables)
# ---------------------------------------------------------------------------
# Table II's and Fig. 13's node shapes (nodes, points a node, K, D)
WIDE_CASES = ((20, 17, 2, 34), (10, 14, 2, 52), (10, 28, 4, 52),
              (10, 43, 6, 52))
# a deployment of Table II's model: 1000 sensors x 4096 points (x is
# 0.56 GB in f32).  The plain version's intermediates at this shape
# (N T K D^2 floats, 38 GB) do not fit beside it, so the kernel's result
# is held against it on the first WIDE_PLAIN_NODES nodes (every node is
# computed alone) and the plain version is timed over node chunks
WIDE_DEPLOY = (1000, 4096, 2, 34)
WIDE_PLAIN_NODES = 8
WIDE_PLAIN_CHUNK = 25
# shapes past the first wide kernel's shared memory (K <= 12 at D = 64,
# K <= 226 at D = 8, no K at D >= 108): a node's statistics over several
# blocks (the lse + split launches)
WIDE_PAST_LIMIT = ((3, 77, 13, 64), (2, 50, 16, 64), (2, 40, 2, 110),
                   (2, 90, 227, 8))
# the deployment shape's time with the first wide design (its recorded
# run in PERF.md's bring-up table), beside the redesign's
FIRST_DESIGN_WIDE_MS = 4.458329772949218


# At D = 34 and 52 two f32 versions of the E-step do not agree to
# tests/test_kernels.py's bars (stated for its D <= 8 sweep): log rho is a
# sum of D^2 products (|y' Wn y| ~ 1e3 on these terms), and the plain
# version itself is up to 5e-5 (r) and 1.1e-3 (sum_x) off an f64
# evaluation of the same inputs (on the CPU, at these cases' inputs).  The
# wide kernel forms log rho in f64, so each wide case holds it to those
# bars against the f64 evaluation (`gmm_estep_nodes_plain(...,
# dtype=torch.float64)`); the share of the bars against the f32 plain
# version is reported beside it.


def _compare_vs_f64(got, plain, exact) -> tuple:
    """Assert tests/test_kernels.py's tolerances against the f64
    evaluation `exact`; returns (the max abs error against it, the worst
    share of its bar an element uses, the worst share of the bars against
    the f32 plain version)."""
    err = share = share_plain = 0.0
    for name, g, p, e in zip(("r", "R", "sum_x", "sum_xx"), got, plain,
                             exact):
        if g is None:
            continue
        rtol, atol = TOL[name]
        diff = (g.double() - e).abs()
        worst = float((diff / (atol + rtol * e.abs())).max())
        if worst > 1.0:
            raise AssertionError(
                f"{name}: the kernel is {float(diff.max())} off the f64 "
                f"evaluation ({worst} of its bar; the f32 plain version: "
                f"{float((p.double() - e).abs().max())})")
        err = max(err, float(diff.max()))
        share = max(share, worst)
        share_plain = max(share_plain, float(
            ((g - p).abs() / (atol + rtol * p.abs())).max()))
    return err, share, share_plain


def phase_gmm_wide_kernel_vs_plain(dev) -> dict:
    rng = np.random.default_rng(15)
    cases = []
    for N, T, K, D in WIDE_CASES + WIDE_PAST_LIMIT:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.tensor(rng.normal(size=(N, T, D)) * 2, dtype=dtype,
                             device=dev)
            mask = torch.tensor(rng.random((N, T)) > 0.2, dtype=dtype,
                                device=dev)
            terms = _random_terms(N, K, D, dev, rng)
            shift = torch.tensor(rng.normal(size=(N, K, D)),
                                 dtype=torch.float32, device=dev)
            for return_r, s in ((True, None), (False, None), (True, shift),
                                (False, shift)):
                args = (x, mask, *terms, 3.0)
                err, share, share_plain = _compare_vs_f64(
                    ops.gmm_estep_nodes(*args, shift=s, return_r=return_r),
                    gmm_estep.gmm_estep_nodes_plain(
                        *args, shift=s, return_r=return_r),
                    gmm_estep.gmm_estep_nodes_plain(
                        *args, shift=s, return_r=return_r,
                        dtype=torch.float64))
                cases.append({"shape": [N, T, K, D], "x": str(dtype)[6:],
                              "variant": gmm_estep.kernel_variant(K, D),
                              "blocks_a_node": gmm_estep.wide_plan(
                                  K, D, x.element_size())["nby"],
                              "return_r": return_r, "shift": s is not None,
                              "max_abs_err_vs_f64": err,
                              "bar_share_vs_f64": share,
                              "bar_share_vs_plain": share_plain})
    # the call's device time at Table II's and Fig. 13's node shapes
    # (launch-bound: a prep, one or two main and an emit launch)
    node_ms = []
    for N, T, K, D in WIDE_CASES:
        x = torch.tensor(rng.normal(size=(N, T, D)) * 2, dtype=torch.float32,
                         device=dev)
        mask = torch.ones(N, T, device=dev)
        terms = _random_terms(N, K, D, dev, rng)
        node_ms.append({"shape": [N, T, K, D], "ms": graph_time_ms(
            lambda: ops.gmm_estep_nodes(x, mask, *terms, 3.0,
                                        return_r=False), 20),
                        "blocks_a_node": gmm_estep.wide_plan(K, D)["nby"]})
    # bit equality: trailing zero padding (1, 64, 500 points) and two
    # launches, plain and centred, at Fig. 13's widest K
    x, mask = (torch.tensor(a, dtype=torch.float32, device=dev) for a in
               (rng.normal(size=(6, 200, 52)), rng.random((6, 200)) > 0.2))
    terms = _random_terms(6, 6, 52, dev, rng)
    pad_equal = repeat_equal = True
    for s in (None, torch.full((6, 6, 52), 0.5, device=dev)):
        base = ops.gmm_estep_nodes(x, mask, *terms, 5.0, shift=s,
                                   return_r=False)
        again = ops.gmm_estep_nodes(x, mask, *terms, 5.0, shift=s,
                                    return_r=False)
        repeat_equal &= all(torch.equal(a, b)
                            for a, b in zip(base[1:], again[1:]))
        for pad in (1, 64, 500):
            padded = ops.gmm_estep_nodes(
                torch.cat([x, x.new_zeros(6, pad, 52)], 1),
                torch.cat([mask, mask.new_zeros(6, pad)], 1), *terms, 5.0,
                shift=s, return_r=False)
            pad_equal &= all(torch.equal(a, b)
                             for a, b in zip(base[1:], padded[1:]))
    torch.cuda.synchronize()
    if not (pad_equal and repeat_equal):
        raise AssertionError("the wide gmm_estep kernel is not "
                             "bit-invariant")

    # the deployment shape: against the plain version on the first nodes,
    # then timed (CUDA events) against its bound, f32 and bf16 x
    N, T, K, D = WIDE_DEPLOY
    gen = torch.Generator(dev).manual_seed(15)
    x32 = torch.randn(N, T, D, generator=gen, device=dev) * 2
    m32 = (torch.rand(N, T, generator=gen, device=dev) > 0.1).float()
    terms = _random_terms(N, K, D, dev, rng)
    shift = torch.randn(N, K, D, generator=gen, device=dev)
    n0 = WIDE_PLAIN_NODES
    timed, deploy_err = {}, {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x, mask = x32.to(dtype), m32.to(dtype)
        got = ops.gmm_estep_nodes(x, mask, *terms, 1.0, shift=shift,
                                  return_r=False)
        first = (x[:n0], mask[:n0], *(t[:n0] for t in terms), 1.0)
        err, share, share_plain = _compare_vs_f64(
            [None] + [g[:n0] for g in got[1:]],
            gmm_estep.gmm_estep_nodes_plain(*first, shift=shift[:n0],
                                            return_r=False),
            gmm_estep.gmm_estep_nodes_plain(*first, shift=shift[:n0],
                                            return_r=False,
                                            dtype=torch.float64))
        deploy_err[name] = {"max_abs_err_vs_f64": err,
                            "bar_share_vs_f64": share,
                            "bar_share_vs_plain": share_plain}
        ms = time_ms(lambda: ops.gmm_estep_nodes(
            x, mask, *terms, 1.0, shift=shift, return_r=False), 5)
        bound, by, n_bytes, flops = _gmm_bound(x, mask, terms, shift, K, D)
        timed[name] = {"ms": ms, "bound_ms": bound, "bound_by": by,
                       "bytes": n_bytes, "flops": flops,
                       "fraction_of_bound": bound / ms,
                       "achieved_TFLOPs": flops / ms / 1e9,
                       "achieved_GBps": n_bytes / ms / 1e6}
        if bound / ms > 1.0:
            raise AssertionError(f"the wide kernel beat its bound: {bound} "
                                 f"ms against {ms} ms")
    del got

    def plain_all():
        for i in range(0, N, WIDE_PLAIN_CHUNK):
            j = slice(i, i + WIDE_PLAIN_CHUNK)
            gmm_estep.gmm_estep_nodes_plain(
                x32[j], m32[j], *(t[j] for t in terms), 1.0, shift=shift[j],
                return_r=False)

    plain_ms = time_ms(plain_all, 1)
    main = timed["f32"]
    out = {"ms": main["ms"], "plain_ms": plain_ms,
           "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
           "max_abs_err": max([c["max_abs_err_vs_f64"] for c in cases]
                              + [e["max_abs_err_vs_f64"]
                                 for e in deploy_err.values()])}
    emit("gmm_wide_kernel_vs_plain", tolerance=TOL, cases=cases,
         worst_bar_share_vs_f64=max(c["bar_share_vs_f64"] for c in cases),
         worst_bar_share_vs_plain=max(c["bar_share_vs_plain"]
                                      for c in cases),
        padding_bit_equal=pad_equal, launches_bit_equal=repeat_equal,
        node_shapes_ms=node_ms,
        deployment={"shape": list(WIDE_DEPLOY),
                    "variant": gmm_estep.kernel_variant(K, D),
                    "vs_plain_first_nodes": n0, "vs_plain": deploy_err,
                    "by_dtype": timed, "plain_ms": plain_ms,
                    "first_design_ms": FIRST_DESIGN_WIDE_MS,
                    "plain_chunk_nodes": WIDE_PLAIN_CHUNK,
                    "plan": gmm_estep.wide_plan(K, D),
                    "workspace_bytes": gmm_estep.wide_workspace_bytes(
                        N, T, K, D)},
        **{k: out[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")})
    del x32, m32, x, mask
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 6b. the engine's remaining dense topologies and ADMM options at full size
# ---------------------------------------------------------------------------
REMAINDER_ITERS = 50
REMAINDER_CASES = ("dsvb_ring", "dsvb_link_drop", "admm_adaptive",
                   "admm_adaptive_per_block_link_drop")


def _remainder_run(name, inst, backend, dev):
    cfg, x, mask, adj, W, prior, ref, init_q = inst
    kw = dict(n_iters=REMAINDER_ITERS, K=cfg.K, D=cfg.D, ref_phi=ref,
              init_q=init_q, backend=backend, device=dev)
    if name == "dsvb_ring":
        mdl = GMMModel(prior, cfg.K, cfg.D, backend=backend, device=dev)
        phi0 = expfam.pack_natural(init_q).expand(x.shape[0], mdl.flat_dim)
        return vb_engine.run_vb(
            mdl, (x, mask), vb_engine.RingDiffusion(),
            n_iters=REMAINDER_ITERS,
            schedule=vb_engine.Schedule(tau=cfg.tau, d0=cfg.d0),
            init_phi=phi0, ref_phi=ref, device=dev)
    if name == "dsvb_link_drop":
        return algorithms.run_dsvb(x, mask, W, prior, tau=cfg.tau, d0=cfg.d0,
                                   link_drop=0.2, link_seed=SEED, **kw)
    extra = ({} if name == "admm_adaptive" else
             dict(per_block=True, link_drop=0.2, link_seed=SEED))
    return algorithms.run_dvb_admm(x, mask, adj, prior, rho=cfg.rho,
                                   xi=cfg.xi, adaptive_rho=True, **extra,
                                   **kw)


def _last_diag(run) -> dict | None:
    d = run.consensus_diag
    if d is None:
        return None
    return {f: getattr(d, f)[-1].tolist()
            for f in ("rho", "dual_on", "clip_count", "reset_count",
                      "link_frac", "kappa")}


def phase_engine_remainder(inst, dev) -> dict:
    _remainder_run("dsvb_ring", inst, "fused", dev)       # warm-up
    torch.cuda.synchronize()
    fused, out = {}, {}
    zero_launches()                                 # this path's window
    for name in REMAINDER_CASES:
        before = ops.gmm_estep_nodes.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = fused[name] = _remainder_run(name, inst, "fused", dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / REMAINDER_ITERS
        launched = ops.gmm_estep_nodes.launches - before
        out[name] = {"ms_per_iter": ms, "launches": launched,
                     "finite": bool(torch.isfinite(run.phi).all()
                                    and torch.isfinite(run.kl_mean).all())}
        if launched != REMAINDER_ITERS or not out[name]["finite"]:
            raise AssertionError(f"{name}: {out[name]}")
    launches = read_launches()
    for name in REMAINDER_CASES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref_run = _remainder_run(name, inst, "reference", dev)
        torch.cuda.synchronize()
        run = fused[name]
        rel = float(((run.kl_mean - ref_run.kl_mean).abs()
                     / ref_run.kl_mean.abs().clamp_min(1e-30)).max())
        out[name].update(
            reference_ms_per_iter=(time.perf_counter() - t0) * 1e3
            / REMAINDER_ITERS, max_rel_kl_diff=rel,
            kl_first=float(run.kl_mean[0]), kl_last=float(run.kl_mean[-1]),
            kl_last_reference=float(ref_run.kl_mean[-1]),
            diag_last=_last_diag(run), diag_last_reference=_last_diag(
                ref_run))
        emit("engine_remainder", case=name, n_iters=REMAINDER_ITERS,
             backend="fused", **out[name])
        torch.testing.assert_close(run.kl_mean, ref_run.kl_mean, rtol=1e-4,
                                   atol=1e-4)
    return {"launches": launches["gmm_estep_nodes"]}


# ---------------------------------------------------------------------------
# 6m. multi-tenant VB serving: VBService fleets at the main path's size
# ---------------------------------------------------------------------------
# every tenant is the paper's instance at 1000 sensors x 4096 points (K=3,
# D=2, f32 data, f64 iterates, fused backend), the seed its own; groups
# B-D reuse seeds 0-3's tensors (made once)
FLEET_TENANTS, FLEET_MAX = 12, 8
FLEET_SLICE, FLEET_SLICE_ALT = 25, 10
FLEET_CAPS = (2600, 3300, 4096)           # true per-node capacities (A)
FLEET_BUDGETS = (50, 100, 200)            # cycled (A)
FLEET_TAUS = (0.2, 0.1)                   # Robbins-Monro tau, lifted (A)
FLEET_RHOS = (0.3, 0.5, 0.8, 1.0)         # adaptive ADMM's initial rho (B)
FLEET_PROFILE_SLOTS = (1, 4, 8)
FLEET_REL = 1e-9


def _fleet_requests(inst, data, dev):
    """{group: [(VBRequest, arrive_at)]} of the four groups: A diffusion
    (Eq. 47), 12 tenants, taus cycled, capacities 2600/3300/4096 all on
    rung 4096, budgets 50/100/200, 8 arriving at slice 0 and 4 at slice
    2; B adaptive dVB-ADMM, 4 tenants with different rho, 200 iterations;
    C RingDiffusion with link_drop 0.2, 4 tenants, 100 iterations; D
    streaming dSVB (B = 512, SVRG), 4 tenants at exact capacity 4096, 200
    iterations.  One topology object a group."""
    cfg, x, mask, adj, W, prior, ref, init_q = inst
    mdl = GMMModel(prior, cfg.K, cfg.D, backend="fused", device=dev)
    phi0 = expfam.pack_natural(init_q).expand(N_NODES, mdl.flat_dim)
    diffusion = vb_engine.Diffusion(W)
    ring = vb_engine.RingDiffusion(link_drop=0.2, link_seed=SEED)
    sched = vb_engine.Schedule(tau=cfg.tau, d0=cfg.d0)

    def req(i, topo, n, **kw):
        return vb_service.VBRequest(model=mdl, data=data[i], topology=topo,
                                    n_iters=n, init_phi=phi0, **kw)

    groups = {"A": [], "B": [], "C": [], "D": []}
    for i in range(FLEET_TENANTS):
        cap = FLEET_CAPS[i % 3]
        xi, mi = data[i]
        groups["A"].append((vb_service.VBRequest(
            model=mdl, data=(xi[:, :cap].contiguous(),
                             mi[:, :cap].contiguous()), topology=diffusion,
            n_iters=FLEET_BUDGETS[i % 3], init_phi=phi0,
            schedule=vb_engine.Schedule(tau=FLEET_TAUS[i % 2], d0=cfg.d0)),
            0 if i < FLEET_MAX else 2))
    for i, rho in enumerate(FLEET_RHOS):
        groups["B"].append((req(i, vb_engine.ADMMConsensus(
            adj, rho=rho, xi=cfg.xi, adaptive_rho=True), 200), 0))
        groups["C"].append((req(i, ring, 100, schedule=sched), 0))
        groups["D"].append((req(i, diffusion, 200, schedule=sched,
                                minibatch=stream_lib.MinibatchSpec(
                                    STREAM_BATCH, SEED, "svrg")), 0))
    return groups


def _fleet_serve(reqs, slice_iters, dev):
    """Submit a group's requests to a fresh VBService and drain it:
    (service, rids, {rid: SessionStatus}, submit s, drain s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svc = vb_service.VBService(slice_iters=slice_iters, max_fleet=FLEET_MAX,
                               bucket="pow2", device=dev)
    rids = [svc.submit(r, arrive_at=a) for r, a in reqs]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = svc.run()
    torch.cuda.synchronize()
    return svc, rids, out, t1 - t0, time.perf_counter() - t1


def _fleet_profile(reqs, n_slots, dev) -> dict:
    """Device kernels, busy ms and wall ms per fleet iteration of group
    A's fleet (8 slots) with `n_slots` of them occupied: one warm slice,
    then one profiled slice (`profile_window`)."""
    svc = vb_service.VBService(slice_iters=FLEET_SLICE, max_fleet=FLEET_MAX,
                               device=dev)
    for r, _ in reqs[:n_slots]:
        svc.submit(r._replace(n_iters=3 * FLEET_SLICE))
    svc.step_slice()
    torch.cuda.synchronize()
    prof = profile_window(svc.step_slice, named=("gmm_estep",))
    return {"occupied": n_slots, "slots": FLEET_MAX,
            "kernels_per_iter": prof["kernels_launched"] / FLEET_SLICE,
            "device_busy_ms_per_iter": prof["device_busy_ms"] / FLEET_SLICE,
            "profiled_wall_ms_per_iter": prof["wall_ms"] / FLEET_SLICE,
            "device_idle_share": prof["device_idle_share"],
            "top_kernels": prof["top"][:4]}


def phase_vb_serve_fleet(inst, dev) -> dict:
    """The serving slice at full width (module docstring, 6m)."""
    t_phase = time.perf_counter()
    cfg = inst[0]
    t0 = time.perf_counter()
    data = []
    for s in range(FLEET_TENANTS):
        d = synthetic.paper_synthetic(n_nodes=N_NODES,
                                      n_per_node=N_PER_NODE, seed=s,
                                      dtype=np.float32)
        data.append((d.x.to(dev), d.mask.to(dev)))
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    groups = _fleet_requests(inst, data, dev)
    # warm-up outside the window: a one-tenant fleet of each group, 2 its
    _ = [_fleet_serve([(r._replace(n_iters=2), 0)], FLEET_SLICE, dev)
         for r, _ in (g[0] for g in groups.values())]
    torch.cuda.reset_peak_memory_stats()
    runs, out = {}, {}
    zero_launches()                                 # the serving window
    for name, reqs in groups.items():
        before = ops.gmm_estep_nodes.launches
        svc, rids, res, sub_s, run_s = _fleet_serve(reqs, FLEET_SLICE, dev)
        launched = ops.gmm_estep_nodes.launches - before
        st = svc.stats()
        iters = st.slices * FLEET_SLICE
        runs[name] = (svc, rids, res)
        out[name] = {
            "tenants": len(reqs), "slices": st.slices,
            "fleet_iterations": iters, "submit_s": sub_s, "drain_s": run_s,
            "sessions_per_s": len(reqs) / (sub_s + run_s),
            "ms_per_fleet_iter": run_s * 1e3 / iters,
            "gmm_estep_launches": launched,
            "gmm_estep_launches_per_fleet_iter": launched / iters,
            "compiles": st.compiles, "admitted": st.admitted,
            "evicted": st.evicted, "occupancy": st.occupancy,
            "buckets": [b._asdict() for b in st.buckets],
            "t": [res[r].t for r in rids],
            "finite": all(bool(torch.isfinite(res[r].phi).all())
                          for r in rids)}
        if not out[name]["finite"] or st.compiles != 1 \
                or st.admitted != len(reqs) or st.queue_depth:
            raise AssertionError(f"fleet {name}: {out[name]}")
        if name != "D" and launched != iters:
            raise AssertionError(f"fleet {name}: {launched} gmm_estep "
                                 f"launches for {iters} fleet iterations")
    launches = read_launches()                      # read just after
    peak = torch.cuda.max_memory_allocated()

    # each tenant against a solo vb_run of its budget on the card, and
    # the same admissions driven in slices of FLEET_SLICE_ALT (every
    # group is measured and printed; a miss fails the phase at its end)
    misses = []
    for name, reqs in groups.items():
        svc, rids, res = runs[name]
        worst, bit_equal = 0.0, True
        for (r, _), rid in zip(reqs, rids):
            solo = vb_engine.run_vb(
                r.model, r.data, r.topology, n_iters=r.n_iters,
                schedule=r.schedule, init_phi=r.init_phi,
                minibatch=r.minibatch, diagnostics=False, device=dev)
            got = res[rid].phi
            bit_equal &= bool(torch.equal(solo.phi, got))
            worst = max(worst, float((solo.phi - got).abs().max()
                                     / solo.phi.abs().max()))
        _, rids2, res2, _, _ = _fleet_serve(reqs, FLEET_SLICE_ALT, dev)
        invariant = all(torch.equal(res[a].phi, res2[b].phi)
                        and res[a].t == res2[b].t
                        for a, b in zip(rids, rids2))
        out[name].update(vs_solo_max_rel=worst, vs_solo_bit_equal=bit_equal,
                         bar="bit-equal" if name == "C" else FLEET_REL,
                         slice_invariant=invariant)
        emit("vb_serve_fleet_group", group=name, nodes=N_NODES,
             points_per_node=N_PER_NODE, slice_iters=FLEET_SLICE,
             max_fleet=FLEET_MAX, **out[name])
        if not invariant:
            misses.append(f"fleet {name}: not bit-invariant to the slice "
                          "length")
        if (name == "C" and not bit_equal) or worst > FLEET_REL:
            misses.append(f"fleet {name} vs solo: {worst}")

    # device kernels per fleet iteration at 1, 4 and 8 occupied slots
    profiles = [_fleet_profile(groups["A"], n, dev)
                for n in FLEET_PROFILE_SLOTS]

    # the kernel at the fleet's shape: group A's buffers (8000 x 4096,
    # f32 x, padded nodes included) on the terms of its final iterate,
    # unreplicated as in phase 4, against its plain version by chunks
    g = next(iter(runs["A"][0]._groups.values()))
    xs, ms_ = (a.reshape((-1,) + a.shape[2:]) for a in g.stream_data[:2])
    q = expfam.unpack_natural(g.phi.reshape(xs.shape[0], -1), cfg.K, cfg.D)
    shift = q.m.float().contiguous()
    terms = [t.contiguous() for t in gmm.estep_terms(q, torch.float32,
                                                     shift=shift)]
    err, share = _compare(
        ops.gmm_estep_nodes(xs, ms_, *terms, shift=shift, return_r=False),
        _plain_by_chunks(xs, ms_, terms, shift))
    k_ms = graph_time_ms(lambda: ops.gmm_estep_nodes(
        xs, ms_, *terms, float(N_NODES), shift=shift, return_r=False), 10)
    bound, by, n_bytes, _ = _gmm_bound(xs, ms_, terms, shift, cfg.K, cfg.D)
    kpi = [p["kernels_per_iter"] for p in profiles]
    emit("vb_serve_fleet", groups=sorted(groups), profiles=profiles,
         kernels_per_iter_8_over_1=kpi[-1] / kpi[0],
         gmm_estep_launches_per_fleet_iter={
             n: o["gmm_estep_launches_per_fleet_iter"]
             for n, o in out.items()},
         compiles={n: o["compiles"] for n, o in out.items()},
         sessions_per_s={n: o["sessions_per_s"] for n, o in out.items()},
         ms_per_fleet_iter={n: o["ms_per_fleet_iter"]
                            for n, o in out.items()},
         fleet_kernel={"nodes": int(xs.shape[0]),
                       "points_per_node": int(xs.shape[1]), "ms": k_ms,
                       "bound_ms": bound, "bound_by": by, "bytes": n_bytes,
                       "fraction_of_bound": bound / k_ms,
                       "max_abs_err": err, "bar_share": share},
         launches=launches, max_memory_allocated=peak,
         data_seconds=data_s, seconds=time.perf_counter() - t_phase)
    if kpi[-1] > 1.5 * kpi[0]:
        misses.append(f"device kernels per fleet iteration: {kpi}")
    if misses:
        raise AssertionError("; ".join(misses))
    return {"launches": launches["gmm_estep_nodes"], "max_abs_err": err,
            "ms": k_ms, "bound_ms": bound}


# ---------------------------------------------------------------------------
# 6c. the paper's Sec. V experiments through the port
# ---------------------------------------------------------------------------
# every estimator run of a figure is cut to this many iterations, to keep
# the script's time (the reduced sizes are the reference's: nothing else
# is cut; PERF.md lists each figure's nominal count)
SEC5_MAX_ITERS = {"fig3_tau_sweep": 150, "fig4_convergence": 300,
                  "fig7_rho_sweep": 150, "fig8_admm_vs_dsvb": 300,
                  "fig9_imbalance": 200, "fig10_network_size": 200,
                  "table1_atmosphere": 200, "table2_ionosphere": 100,
                  "fig13_coil20": 60}
# strings the two backends must give alike; the other derived numbers
# (ratios, accuracies) may differ by at most SEC5_NUM_TOL
SEC5_EXACT = ("fig3_tau_sweep", "fig7_rho_sweep", "fig10_network_size")
SEC5_NUM_TOL = 0.01


def _numbers(derived: str) -> list:
    return [float(v) for v in re.findall(r"-?\d+\.?\d*(?:e-?\d+)?",
                                         derived)]


def phase_paper_sec5(dev) -> dict:
    with open(os.path.join(HERE, "BENCH_engine.json")) as f:
        bench = json.load(f)["results"]
    rows = {fn.__name__: {} for fn in paper_figures.ALL}
    launches = None
    for backend in ("fused", "reference"):
        results = {}             # fig4 reads fig3's tau from here
        if backend == "fused":
            zero_launches()                         # this path's window
        for fn in paper_figures.ALL:
            t0 = time.perf_counter()
            (name, us, derived), = fn(
                False, backend=backend, device=dev,
                max_iters=SEC5_MAX_ITERS[fn.__name__], results=results)
            rows[name][backend] = {"derived": derived,
                                   "us_per_iter_last_run": us,
                                   "seconds": time.perf_counter() - t0}
        if backend == "fused":
            launches = {**read_launches(),
                        "gmm_estep_nodes_by_variant":
                            read_gmm_variant_launches()}
    bad = []
    for name, r in rows.items():
        f, g = r["fused"]["derived"], r["reference"]["derived"]
        a, b = _numbers(f), _numbers(g)
        agree = (f == g if name in SEC5_EXACT else
                 len(a) == len(b) and all(abs(u - v) <= SEC5_NUM_TOL + 1e-9
                                          for u, v in zip(a, b)))
        r.update(bench_engine_json=bench.get(name, {}).get("derived"),
                 agree=agree)
        emit("paper_sec5", figure=name, max_iters=SEC5_MAX_ITERS[name],
             **r)
        if not agree:
            bad.append(name)
    wide = launches["gmm_estep_nodes_by_variant"]["wide"]
    emit("paper_sec5_launches", **launches)
    if bad:
        raise AssertionError(f"fused and reference backends disagree on "
                             f"{bad}")
    if wide == 0:
        raise AssertionError("Table II / Fig. 13 did not launch the wide "
                             "gmm_estep kernel")
    return {"wide_launches": wide, "launches": launches}


# ---------------------------------------------------------------------------
# 6d. streaming minibatches and SVRG on the main path's instance
# ---------------------------------------------------------------------------
STREAM_ITERS, STREAM_BATCH = 200, 512


def _stream_run(inst, backend, dev, minibatch, n_iters=None,
                link_drop=0.0):
    """dSVB on Diffusion (Eq. 47 weights) from the main path's restart,
    STREAM_ITERS iterations unless told otherwise."""
    cfg, x, mask, adj, W, prior, ref, init_q = inst
    n_iters = STREAM_ITERS if n_iters is None else n_iters
    mdl = GMMModel(prior, cfg.K, cfg.D, backend=backend, device=dev)
    phi0 = expfam.pack_natural(init_q).expand(x.shape[0], mdl.flat_dim)
    return vb_engine.run_vb(
        mdl, (x, mask), vb_engine.Diffusion(W, link_drop=link_drop,
                                            link_seed=SEED),
        n_iters=n_iters, schedule=vb_engine.Schedule(tau=cfg.tau,
                                                     d0=cfg.d0),
        init_phi=phi0, ref_phi=ref, minibatch=minibatch, device=dev)


def _svrg_launches(n_iters, n_chunks):
    """gmm_estep launches of an SVRG run: two an iteration, the anchor at
    t = 0 and one at each epoch change."""
    return 2 * n_iters + 1 + (n_iters - 1) // n_chunks


def phase_stream_main_path(inst, dev):
    """The slice's path at full width: N = 1000 x 4096, B = 512, dSVB,
    plain and SVRG, fused and reference backends."""
    cfg, x, mask = inst[:3]
    T = mask.shape[1]
    n_chunks = -(-T // STREAM_BATCH)
    specs = {"plain": stream_lib.MinibatchSpec(STREAM_BATCH, SEED),
             "svrg": stream_lib.MinibatchSpec(STREAM_BATCH, SEED, "svrg")}
    _stream_run(inst, "fused", dev, specs["svrg"], n_iters=2)  # warm-up
    torch.cuda.synchronize()
    fused, out = {}, {}
    zero_launches()                                 # this path's window
    for name, spec in specs.items():
        before = ops.gmm_estep_nodes.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = fused[name] = _stream_run(inst, "fused", dev, spec)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / STREAM_ITERS
        launched = ops.gmm_estep_nodes.launches - before
        want = (STREAM_ITERS if name == "plain"
                else _svrg_launches(STREAM_ITERS, n_chunks))
        out[name] = {"ms_per_iter": ms, "launches": launched,
                     "launches_expected": want,
                     "finite": bool(torch.isfinite(run.phi).all()
                                    and torch.isfinite(run.kl_mean).all())}
        if launched != want or not out[name]["finite"]:
            raise AssertionError(f"stream {name}: {out[name]}")
    launches = read_launches()                      # read just after
    full = _stream_run(inst, "fused", dev, None)
    for name, spec in specs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref_run = _stream_run(inst, "reference", dev, spec)
        torch.cuda.synchronize()
        run = fused[name]
        rel = float(((run.kl_mean - ref_run.kl_mean).abs()
                     / ref_run.kl_mean.abs().clamp_min(1e-30)).max())
        out[name].update(
            reference_ms_per_iter=(time.perf_counter() - t0) * 1e3
            / STREAM_ITERS, max_rel_kl_diff=rel,
            kl_first=float(run.kl_mean[0]), kl_last=float(run.kl_mean[-1]),
            kl_last_reference=float(ref_run.kl_mean[-1]),
            kl_ratio_to_full_batch=float(run.kl_mean[-1] / full.kl_mean[-1]))
        emit("stream_main_path", case=name, nodes=x.shape[0],
             points_per_node=T, batch_size=STREAM_BATCH,
             n_iters=STREAM_ITERS, backend="fused",
             kl_last_full_batch=float(full.kl_mean[-1]), **out[name])
        torch.testing.assert_close(run.kl_mean, ref_run.kl_mean, rtol=1e-4,
                                   atol=1e-4)
    # B = capacity: the full-batch run, bit for bit (plain and svrg)
    bit_equal = {}
    for name in specs:
        spec = stream_lib.MinibatchSpec(T, SEED, None if name == "plain"
                                        else "svrg")
        run = _stream_run(inst, "fused", dev, spec)
        bit_equal[name] = bool(torch.equal(run.phi, full.phi)
                               and torch.equal(run.kl_nodes, full.kl_nodes))
    # the kernel on the iteration's (1000, 512, 2) gather: the engine's
    # terms, the scaled mask T/B, f32 x
    q = expfam.unpack_natural(fused["plain"].phi, cfg.K, cfg.D)
    shift = q.m.float().contiguous()
    terms = [t.contiguous() for t in gmm.estep_terms(q, torch.float32,
                                                     shift=shift)]
    st = stream_lib.init_state(x.shape[0], SEED, T, device=dev)
    _, idx, mb = stream_lib.advance(st, mask, 3, STREAM_BATCH)
    xb = torch.gather(x, 1, idx[..., None].expand(-1, -1, cfg.D))
    args = (xb, mb, *terms, float(x.shape[0]))
    ms = graph_time_ms(lambda: ops.gmm_estep_nodes(
        *args, shift=shift, return_r=False), 20)
    call_ms = time_ms(lambda: ops.gmm_estep_nodes(
        *args, shift=shift, return_r=False), 100)
    plain_ms = time_ms(lambda: gmm_estep.gmm_estep_nodes_plain(
        *args, shift=shift, return_r=False), 10)
    bound, by, n_bytes, flops = _gmm_bound(xb, mb, terms, shift, cfg.K,
                                           cfg.D)
    emit("stream_main_path_kernel", shape=list(xb.shape), mask_scale=float(
        mb.max()), ms=ms, call_ms=call_ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, bytes=n_bytes, flops=flops,
        fraction_of_bound=bound / ms, bit_equal_full_batch=bit_equal,
        launches=launches)
    if not all(bit_equal.values()):
        raise AssertionError(f"B = capacity is not the full-batch run: "
                             f"{bit_equal}")


def phase_stream_cpu_vs_card(dev):
    """F4: a small streaming run with link_drop=0.2 on the CPU and on the
    card, the port's own permutations and coins: the masks and index sets
    are equal bit for bit, the reference backend's trajectories agree to
    1e-9 relative."""
    cpu = torch.device("cpu")
    n_iters, B = 24, 10
    devs = {"card": dev, "cpu": cpu}
    insts = {d: _instance(8, 40, devs[d]) for d in devs}
    masks_equal = indices_equal = True
    st = {d: stream_lib.init_state(8, SEED, 40, device=devs[d])
          for d in devs}
    for t in range(n_iters):
        keep = {d: network.link_keep_matrix(
            network.link_generator(SEED, t, devs[d]), 8, 0.2)
            for d in devs}
        masks_equal &= torch.equal(keep["card"].cpu(), keep["cpu"])
        drawn = {}
        for d in devs:
            st[d], idx, mb = stream_lib.advance(st[d], insts[d][2], t, B)
            drawn[d] = (idx.cpu(), mb.cpu())
        indices_equal &= (torch.equal(drawn["card"][0], drawn["cpu"][0])
                          and torch.equal(drawn["card"][1], drawn["cpu"][1]))
    rel = {}
    for cv in (None, "svrg"):
        spec = stream_lib.MinibatchSpec(B, SEED, cv)
        runs = {d: _stream_run(insts[d], "reference", devs[d], spec,
                               n_iters=n_iters, link_drop=0.2)
                for d in devs}
        a, b = runs["card"].kl_nodes.cpu(), runs["cpu"].kl_nodes
        rel[cv or "plain"] = float(((a - b).abs() / b.abs()).max())
    emit("stream_cpu_vs_card", nodes=8, points_per_node=40, batch_size=B,
         n_iters=n_iters, link_drop=0.2, masks_bit_equal=masks_equal,
         indices_bit_equal=indices_equal, max_rel_kl_diff=rel)
    if not (masks_equal and indices_equal) or max(rel.values()) > 1e-9:
        raise AssertionError("CPU and card streams differ")


# (nodes, capacity T, batch B, K, D): masks scaled T/B = 8, 40.96 and 5
# on the register, shared-memory and wide paths
SCALED_MASK_CASES = ((1000, 4096, 512, 3, 2), (200, 4096, 100, 3, 2),
                     (50, 100, 20, 3, 2), (50, 1000, 200, 8, 2),
                     (20, 170, 34, 2, 34))


def phase_stream_scaled_mask_kernel(dev):
    """gmm_estep_nodes against its plain version on streaming gathers with
    the scaled mask `stream.advance` makes.  Every output is linear in the
    mask, so both are compared per unit of weight (divided by T/B): the
    units of the 0/1 masks tests/test_kernels.py's bars are set for (D > 8
    against an f64 evaluation, as the wide phase)."""
    rng = np.random.default_rng(16)
    cases = []
    for N, T, B, K, D in SCALED_MASK_CASES:
        x = torch.tensor(rng.normal(size=(N, T, D)) * 2, dtype=torch.float32,
                         device=dev)
        mask = torch.tensor(rng.random((N, T)) > 0.2, dtype=torch.float32,
                            device=dev)
        terms = _random_terms(N, K, D, dev, rng)
        st = stream_lib.init_state(N, SEED, T, device=dev)
        _, idx, mb = stream_lib.advance(st, mask, 1, B)
        xb = torch.gather(x, 1, idx[..., None].expand(-1, -1, D))
        scale = T / B
        for dtype in (torch.float32, torch.bfloat16):
            args = (xb.to(dtype), mb.to(dtype), *terms)
            got = [None if g is None else g / scale
                   for g in ops.gmm_estep_nodes(*args)]
            plain = [None if w is None else w / scale
                     for w in gmm_estep.gmm_estep_nodes_plain(*args)]
            if D > 8:
                exact = [w / scale for w in gmm_estep.gmm_estep_nodes_plain(
                    *args, dtype=torch.float64)]
                err, share, _ = _compare_vs_f64(got, plain, exact)
            else:
                err, share = _compare(got, plain)
            cases.append({"shape": [N, B, K, D], "capacity": T,
                          "mask_scale": scale,
                          "mask_scale_in_x_dtype": float(mb.to(dtype).max()),
                          "x": str(dtype)[6:],
                          "variant": gmm_estep.kernel_variant(K, D),
                          "max_abs_err_per_weight": err, "bar_share": share})
    emit("stream_scaled_mask_kernel", tolerance=TOL, cases=cases,
         worst_bar_share=max(c["bar_share"] for c in cases))


def phase_streaming_experiments(dev):
    """experiments/streaming.py at the benchmarks' sizes (50 nodes x 100
    points, B = 20), fused backend: both benchmarks assert their bars."""
    results = {}
    zero_launches()                                 # this path's window
    t0 = time.perf_counter()
    rows = []
    for fn in streaming.ALL:
        rows += fn(False, backend="fused", device=dev, results=results)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    emit("streaming_experiments", seconds=seconds, launches=launches,
         rows=[{"name": n, "us_per_iter": us, "derived": d}
               for n, us, d in rows], **results)
    if launches["gmm_estep_nodes"] == 0:
        raise AssertionError("the streaming benchmarks launched no kernel")


# the model zoo at a sensor fleet's size: HMM 1000 sensors x 8 chains x 64
# steps (K=3, D=2), PPCA 1000 sensors x 4096 points (D=6, Q=2)
ZOO_HMM = (1000, 8, 64)
ZOO_PPCA = (1000, 4096, 6, 2)
ZOO_ITERS, ZOO_PROFILE_ITERS, ZOO_FALLBACK_ITERS = 20, 10, 3


def _zoo_models(dev):
    gen = torch.Generator().manual_seed(SEED)
    N, S, L = ZOO_HMM
    t0 = time.perf_counter()
    hx, hmask = hmm.sample_chains(N, S, L, K=3, D=2, seed=SEED)[:2]
    sample_s = {"hmm_sample_chains": time.perf_counter() - t0}
    hm = hmm.HMMModel(hmm.noninformative_prior(3, 2, beta0=0.1,
                                               w0_scale=10.0, device=dev),
                      device=dev)
    hphi = hm.pack(hmm.perturbed_init(hm.prior, hx, generator=gen))
    N, T, Dp, Q = ZOO_PPCA
    t0 = time.perf_counter()
    px, pmask = ppca.sample_sensors(N, T, D=Dp, Q=Q, seed=SEED)[:2]
    sample_s["ppca_sample_sensors"] = time.perf_counter() - t0
    pm = ppca.PPCAModel(ppca.prior(Dp, Q, device=dev), device=dev)
    pphi = pm.pack(ppca.perturbed_init(pm.prior, generator=gen))
    adj, _ = network.random_geometric_graph(N, seed=SEED)
    W = network.nearest_neighbor_weights(adj)
    return ({"hmm": (hm, (hx.to(dev), hmask.to(dev)), hphi),
             "ppca": (pm, (px.to(dev), pmask.to(dev)), pphi)},
            adj.to(dev), W.to(dev), sample_s)


def phase_model_zoo(dev):
    """HMM and PPCA through dSVB (Diffusion) and dVB-ADMM at a sensor
    fleet's size; F5: backend="fused" warns and equals the reference
    backend's run bit for bit."""
    models, adj, W, sample_s = _zoo_models(dev)
    for name, (mdl, data, phi) in models.items():
        phi0 = phi.expand(data[0].shape[0], -1)
        for est, topo, kw in (
                ("dsvb", vb_engine.Diffusion(W),
                 dict(schedule=vb_engine.Schedule())),
                ("dvb_admm", vb_engine.ADMMConsensus(adj), {})):
            def go(n, **extra):
                return vb_engine.run_vb(mdl, data, topo, n_iters=n,
                                        init_phi=phi0, device=dev,
                                        **kw, **extra)

            go(2)                                   # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run = go(ZOO_ITERS)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / ZOO_ITERS
            prof = profile_window(lambda: go(ZOO_PROFILE_ITERS))
            ref = go(ZOO_FALLBACK_ITERS)
            backends_lib._WARNED.clear()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fb = go(ZOO_FALLBACK_ITERS, backend="fused")
            warned = [str(w.message) for w in caught
                      if "falling back to the reference backend"
                      in str(w.message)]
            res = {
                "ms_per_iter": ms, "finite": bool(torch.isfinite(
                    run.phi).all()),
                "kernels_per_iter": prof["kernels_launched"]
                / ZOO_PROFILE_ITERS,
                "device_busy_ms_per_iter": prof["device_busy_ms"]
                / ZOO_PROFILE_ITERS,
                "device_idle_share": prof["device_idle_share"],
                "fused_warned": len(warned) == 1,
                "fused_bit_equal_reference": bool(torch.equal(fb.phi,
                                                              ref.phi))}
            emit("model_zoo", model=name, estimator=est, n_iters=ZOO_ITERS,
                 shape=list(data[0].shape), **res)
            if not (res["finite"] and res["fused_warned"]
                    and res["fused_bit_equal_reference"]):
                raise AssertionError(f"{name} {est}: {res}")
    emit("model_zoo_host", **sample_s)


# ---------------------------------------------------------------------------
# 6i-6l. sparse topologies at 100,000 sensors; sessions and checkpoints
# ---------------------------------------------------------------------------
# The sparse main path: the paper's experiment at N = 100,000 sensors x
# 4096 points, the first power of ten where the dense f64 mixing matrix
# (80 GB) does not fit the card; the edge lists are O(E + N)
SPARSE_N, SPARSE_ITERS = 100_000, 20
SPARSE_CASES = ("dsvb", "nsg_dvb", "dvb_admm_adaptive", "ring_link_drop",
                "gossip", "hierarchical")
GOSSIP_P, GOSSIP_SEED = 0.3, 5
SPARSE_GRAPH_MAX_S = 30.0
# nodes a plain-version (or reference-backend) call takes at 100,000
# sensors, and the sparse dSVB iterations held against the reference
SPARSE_CHUNK, SPARSE_REF_ITERS = 8192, 3
# sparse against dense where the dense oracle still fits (800 MB)
SPARSE_VS_DENSE_N, SPARSE_VS_DENSE_ITERS = 10_000, 20
SPARSE_CPU_N, SPARSE_CPU_T = 1000, 20
# the checkpoint round trips: save at t = a, restore, continue b
CKPT_N, CKPT_T, CKPT_A, CKPT_B, CKPT_BATCH = 1000, 256, 5, 5, 64
CKPT_DIR = os.path.join(HERE, "build", "chip_smoke_ckpt")
def _ref_posterior(x, mask, labels, prior, K, chunk=2048):
    """The Eq. 46 reference (the true-label posterior, as `_instance`),
    accumulated a chunk of nodes at a time."""
    parts = []
    for lo in range(0, x.shape[0], chunk):
        r = torch.nn.functional.one_hot(labels[lo:lo + chunk].long(), K)
        r = r.double() * mask[lo:lo + chunk].double()[..., None]
        parts.append(gmm.sufficient_stats(x[lo:lo + chunk].double(), r, 1.0))
    st = [torch.cat(p) for p in zip(*parts)]
    return gmm.posterior_from_stats(
        gmm.SuffStats(*(expfam.ordered_sum(a) for a in st)), prior)


def _sparse_instance(data, dev):
    """(cfg, x, mask, prior, ref stack, init_q) on `dev` from host data:
    f32 data, f64 prior, iterates and metric (as `_instance`)."""
    cfg = GMMSensorConfig()
    prior = expfam.noninformative_prior(
        cfg.K, cfg.D, alpha0=cfg.alpha0, beta0=cfg.beta0,
        w0_scale=cfg.w0_scale, dtype=torch.float64, device=dev)
    x, mask = data.x.to(dev), data.mask.to(dev)
    ref = refperm.permuted_refs(_ref_posterior(
        x, mask, data.labels.to(dev), prior, cfg.K))
    u = np.random.default_rng(SEED).uniform(size=(cfg.K, cfg.D))
    lo, hi = x.reshape(-1, cfg.D).amin(0), x.reshape(-1, cfg.D).amax(0)
    init_q = prior._replace(m=(lo + (hi - lo) * torch.tensor(
        u, dtype=torch.float32, device=dev)).double())
    return cfg, x, mask, prior, ref, init_q


def _sparse_topology(name, cfg, g, n):
    """(topology, schedule) of a sparse case."""
    sched = vb_engine.Schedule(tau=cfg.tau, d0=cfg.d0)
    if name == "dsvb":
        return vb_engine.Diffusion(
            network.sparse_nearest_neighbor_weights(g)), sched
    if name == "nsg_dvb":
        return vb_engine.Diffusion(
            network.sparse_nearest_neighbor_weights(g)), vb_engine.ONE_SHOT
    if name == "dsvb_link_drop":
        return vb_engine.Diffusion(
            network.sparse_nearest_neighbor_weights(g), link_drop=0.2,
            link_seed=SEED), sched
    if name == "dvb_admm_adaptive":
        return vb_engine.ADMMConsensus(g, rho=cfg.rho, xi=cfg.xi,
                                       adaptive_rho=True), \
            vb_engine.Schedule()
    if name == "admm_adaptive_per_block_link_drop":
        return vb_engine.ADMMConsensus(
            g, rho=cfg.rho, xi=cfg.xi, adaptive_rho=True, per_block=True,
            link_drop=0.2, link_seed=SEED), vb_engine.Schedule()
    if name == "ring_link_drop":
        return vb_engine.RingDiffusion(graph=network.SparseGraph.ring(n),
                                       link_drop=0.2, link_seed=SEED), sched
    if name == "gossip":
        return vb_engine.PairwiseGossip(g, p_activate=GOSSIP_P,
                                        seed=GOSSIP_SEED), sched
    if name == "hierarchical":
        gw, rg = network.two_level_partition(n, n // 16, n // 128)
        return vb_engine.HierarchicalFusion(gw, rg), sched
    raise KeyError(name)


def _sparse_run(name, inst, g, backend, n_iters, dev):
    """A sparse case through the entry point a user calls: the
    algorithms.run_* wrapper for the paper's estimators, run_vb for the
    scenario topologies."""
    cfg, x, mask, prior, ref, init_q = inst
    kw = dict(n_iters=n_iters, K=cfg.K, D=cfg.D, ref_phi=ref, init_q=init_q,
              backend=backend, device=dev)
    if name in ("dsvb", "nsg_dvb"):
        sw = network.sparse_nearest_neighbor_weights(g)
        if name == "dsvb":
            return algorithms.run_dsvb(x, mask, sw, prior, tau=cfg.tau,
                                       d0=cfg.d0, **kw)
        return algorithms.run_nsg_dvb(x, mask, sw, prior, **kw)
    if name == "dvb_admm_adaptive":
        return algorithms.run_dvb_admm(x, mask, g, prior, rho=cfg.rho,
                                       xi=cfg.xi, adaptive_rho=True, **kw)
    topo, sched = _sparse_topology(name, cfg, g, x.shape[0])
    mdl = GMMModel(prior, cfg.K, cfg.D, backend=backend, device=dev)
    phi0 = expfam.pack_natural(init_q).expand(x.shape[0], mdl.flat_dim)
    return vb_engine.run_vb(mdl, (x, mask), topo, n_iters=n_iters,
                            schedule=sched, init_phi=phi0, ref_phi=ref,
                            device=dev)


def _sparse_state(name, inst, g, backend, dev, minibatch=None):
    cfg, x, mask, prior, ref, init_q = inst
    topo, sched = _sparse_topology(name, cfg, g, x.shape[0])
    mdl = GMMModel(prior, cfg.K, cfg.D, backend=backend, device=dev)
    phi0 = expfam.pack_natural(init_q).expand(x.shape[0], mdl.flat_dim)
    return vb_engine.vb_init(mdl, (x, mask), topo, schedule=sched,
                             init_phi=phi0, ref_phi=ref, minibatch=minibatch,
                             device=dev)


def _live_cuda_tensors(top: int = 6) -> list:
    """The largest CUDA storages that Python objects hold now (found
    through the garbage collector): [{bytes, dtype, shape}]."""
    seen = {}
    for o in gc.get_objects():
        if isinstance(o, torch.Tensor) and o.is_cuda:
            st = o.untyped_storage()
            seen.setdefault(st.data_ptr(), {
                "bytes": st.nbytes(), "dtype": str(o.dtype)[6:],
                "shape": list(o.shape)})
    return sorted(seen.values(), key=lambda v: -v["bytes"])[:top]


def _alloc_site(frames) -> str:
    for f in frames:                    # innermost first
        name = f["filename"]
        if "repro_torch" in name or name.endswith("chip_smoke.py"):
            return f"{name.split('src/')[-1]}:{f['line']} ({f['name']})"
    return "other"


def _peak_sites(fn, top: int = 4) -> dict:
    """Run fn() with the allocator's history on and replay it: the peak
    of what fn() allocated (bytes above what was held before), and the
    allocations live at that peak summed by the innermost source line of
    the port that made them."""
    torch.cuda.synchronize()
    torch.cuda.memory._record_memory_history(
        enabled="all", context="alloc", stacks="python", max_entries=200_000)
    try:
        fn()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    live, cur, peak, at_peak = {}, 0, 0, {}
    for e in snap["device_traces"][torch.cuda.current_device()]:
        if e["action"] == "alloc":
            live[e["addr"]] = (e["size"], e["frames"])
            cur += e["size"]
            if cur > peak:
                peak, at_peak = cur, dict(live)
        elif e["action"] == "free_completed" and e["addr"] in live:
            cur -= live.pop(e["addr"])[0]
    sites = {}
    for size, frames in at_peak.values():
        site = _alloc_site(frames)
        sites[site] = sites.get(site, 0) + size
    return {"transient_peak_bytes": peak,
            "transient_sites": sorted(([k, v] for k, v in sites.items()),
                                      key=lambda kv: -kv[1])[:top]}


@dataclasses.dataclass(frozen=True)
class _ReferenceByChunks:
    """The reference backend (core/gmm.py as-is), a chunk of nodes at a
    time: at 100,000 x 4096 its f64 passes over the whole data would not
    fit the card at once.  Each node's optimum is its own, so the chunks
    change no result."""

    name: str = "reference"

    def supports(self, model) -> bool:
        return True

    def local_vbm_optimum_nodes(self, x, mask, phi_nodes, prior,
                                replication, K, D):
        return torch.cat([gmm.local_vbm_optimum_nodes(
            x[s:s + SPARSE_CHUNK], phi_nodes[s:s + SPARSE_CHUNK], prior,
            replication, K, D, mask[s:s + SPARSE_CHUNK])
            for s in range(0, x.shape[0], SPARSE_CHUNK)])


def _plain_by_chunks(x, mask, terms, shift):
    """gmm_estep_nodes_plain (no r) a chunk of nodes at a time."""
    parts = [gmm_estep.gmm_estep_nodes_plain(
        x[s:s + SPARSE_CHUNK], mask[s:s + SPARSE_CHUNK],
        *(t[s:s + SPARSE_CHUNK] for t in terms),
        shift=shift[s:s + SPARSE_CHUNK], return_r=False)[1:]
        for s in range(0, x.shape[0], SPARSE_CHUNK)]
    return (None, *(torch.cat(p) for p in zip(*parts)))


def phase_sparse_main_path(dev) -> dict:
    """Six sparse runs at 100,000 sensors x 4096 points, fused backend,
    SPARSE_ITERS iterations each; then the kernel at that size against
    its plain version, and sparse dSVB against the reference backend."""
    t0 = time.perf_counter()
    g, _pos = network.random_geometric_edges(SPARSE_N, seed=SEED)
    graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = synthetic.paper_synthetic(n_nodes=SPARSE_N, n_per_node=N_PER_NODE,
                                     seed=SEED, dtype=np.float32)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    inst = _sparse_instance(data, dev)
    del data
    torch.cuda.synchronize()
    data_bytes = inst[1].numel() * 4 + inst[2].numel() * 4
    emit("sparse_main_path_setup", nodes=SPARSE_N,
         points_per_node=N_PER_NODE, links=g.n_undirected,
         directed_edges=2 * g.n_undirected,
         mean_degree=2 * g.n_undirected / SPARSE_N,
         graph_build_seconds=graph_s, data_seconds=data_s,
         instance_seconds=time.perf_counter() - t0, data_bytes=data_bytes,
         dense_f64_matrix_bytes=8 * SPARSE_N * SPARSE_N)
    if graph_s >= SPARSE_GRAPH_MAX_S:
        raise AssertionError(f"random_geometric_edges({SPARSE_N}) took "
                             f"{graph_s:.1f} s")
    gd = g.to(dev)
    for name in SPARSE_CASES:                       # warm-up, outside
        _sparse_run(name, inst, gd, "fused", 2, dev)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    held_by = _live_cuda_tensors()
    out, dsvb = {}, None
    zero_launches()                                 # this path's window
    for name in SPARSE_CASES:
        before = ops.gmm_estep_nodes.launches
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = _sparse_run(name, inst, gd, "fused", SPARSE_ITERS, dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / SPARSE_ITERS
        launched = ops.gmm_estep_nodes.launches - before
        out[name] = {"ms_per_iter": ms, "launches": launched,
                     "kl_first": float(run.kl_mean[0]),
                     "kl_last": float(run.kl_mean[-1]),
                     "finite": bool(torch.isfinite(run.phi).all()
                                    and torch.isfinite(run.kl_mean).all()),
                     "peak_bytes": torch.cuda.max_memory_allocated()}
        if name == "dvb_admm_adaptive":
            out[name]["diag_last"] = _last_diag(run)
        if name == "dsvb":
            dsvb = run
        del run
        if launched != SPARSE_ITERS or not out[name]["finite"]:
            raise AssertionError(f"sparse {name}: {out[name]}")
    launches = read_launches()                      # read just after
    peak = max(o["peak_bytes"] for o in out.values())
    # device kernels an iteration (two profiled iterations a case), what
    # two iterations allocate at their peak, and every operator's shapes
    # over one iteration (no (N, N) tensor)
    for name in SPARSE_CASES:
        state = _sparse_state(name, inst, gd, "fused", dev)
        prof = profile_window(lambda: vb_engine.vb_run(state, 2))
        mem = _peak_sites(lambda: vb_engine.vb_run(state, 2))
        ops_seen = topology_scale.op_shapes(lambda: vb_engine.vb_step(state))
        square = topology_scale.square_ops(ops_seen, SPARSE_N)
        out[name].update(
            kernels_per_iter=prof["kernels_launched"] / 2,
            device_busy_ms_per_iter=prof["device_busy_ms"] / 2,
            profiled_wall_ms_per_iter=prof["wall_ms"] / 2,
            device_idle_share=prof["device_idle_share"],
            top_kernels=prof["top"][:4], **mem,
            operators_recorded=len(ops_seen), square_tensor_ops=len(square))
        emit("sparse_main_path", case=name, nodes=SPARSE_N,
             points_per_node=N_PER_NODE, n_iters=SPARSE_ITERS,
             backend="fused", **out[name])
        if square or not ops_seen:
            raise AssertionError(f"sparse {name}: (N, N)-sized operators "
                                 f"{square[:3]}")
    emit("sparse_main_path_memory", max_memory_allocated=peak,
         held_at_window_start=held, held_by=held_by, data_bytes=data_bytes,
         peak_over_data=peak / data_bytes,
         dense_f64_matrix_bytes=8 * SPARSE_N * SPARSE_N,
         launches=launches)
    # the kernel at this size (the main path's call: f32 x, the terms
    # centred on the component means of sparse dSVB's last iterate, no r,
    # unreplicated as in phase 4) against its plain version
    cfg, x, mask, prior, ref, init_q = inst
    q = expfam.unpack_natural(dsvb.phi, cfg.K, cfg.D)
    shift = q.m.float().contiguous()
    terms = [t.contiguous() for t in gmm.estep_terms(q, torch.float32,
                                                     shift=shift)]
    err, share = _compare(
        ops.gmm_estep_nodes(x, mask, *terms, shift=shift, return_r=False),
        _plain_by_chunks(x, mask, terms, shift))
    # sparse dSVB's first iterations: fused against the reference backend
    sw = network.sparse_nearest_neighbor_weights(gd)
    t0 = time.perf_counter()
    ref_run = algorithms.run_dsvb(
        x, mask, sw, prior, tau=cfg.tau, d0=cfg.d0, n_iters=SPARSE_REF_ITERS,
        K=cfg.K, D=cfg.D, ref_phi=ref, init_q=init_q,
        backend=_ReferenceByChunks(), device=dev)
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3 / SPARSE_REF_ITERS
    f, r = dsvb.kl_mean[:SPARSE_REF_ITERS], ref_run.kl_mean
    emit("sparse_main_path_kernel", kernel="gmm_estep_nodes",
         variant=gmm_estep.kernel_variant(cfg.K, cfg.D), nodes=SPARSE_N,
         points_per_node=N_PER_NODE, tolerance=TOL, max_abs_err=err,
         bar_share=share, vs_reference_iters=SPARSE_REF_ITERS,
         reference_ms_per_iter=ref_ms,
         max_rel_kl_diff=float(((f - r).abs() / r.abs()).max()),
         kl_fused=f.tolist(), kl_reference=r.tolist())
    torch.testing.assert_close(f, r, rtol=1e-4, atol=1e-4)
    return {"launches": launches["gmm_estep_nodes"], "max_abs_err": err}


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def phase_sparse_vs_dense_card(dev) -> None:
    """At 10,000 x 4096, where the dense oracle still fits: one combine
    sparse against dense (<= 1e-12 relative), fused against reference
    over 20 sparse iterations (1e-4), the combine twice bit-equal, and a
    sparse session on the CPU against the card (<= 1e-12 relative after
    one iteration, the same coins)."""
    n = SPARSE_VS_DENSE_N
    g, _ = network.random_geometric_edges(n, seed=SEED)
    gd = g.to(dev)
    A = torch.from_numpy(g.to_dense()).to(dev)
    W = network.nearest_neighbor_weights(A)
    sw = network.sparse_nearest_neighbor_weights(g)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    v = torch.rand((n, expfam.flat_dim(3, 2)), generator=gen,
                   dtype=torch.float64, device=dev) + 1.0
    keep = network.sparse_link_keep(network.link_generator(SEED, 3, dev),
                                    g.n_undirected, 0.2, torch.float64)
    dense_keep = torch.zeros_like(A)
    dense_keep[gd.senders, gd.receivers] = keep[gd.edge_id]
    rel = {
        "diffusion": _rel(vb_engine.Diffusion(sw).to(dev).combine(v),
                          vb_engine.Diffusion(W).combine(v)),
        "diffusion_link_drop": _rel(
            vb_engine.Diffusion(sw, link_mask_fn=lambda t: keep
                                ).to(dev).combine(v, t=3),
            vb_engine.Diffusion(W, link_mask_fn=lambda t: dense_keep
                                ).combine(v, t=3)),
        "ring_link_drop": _rel(
            vb_engine.RingDiffusion(graph=network.SparseGraph.ring(n),
                                    link_drop=0.2).to(dev).combine(v, t=3),
            vb_engine.RingDiffusion(link_drop=0.2).combine(v, t=3)),
    }
    deg_s, ns_s, _ = vb_engine.ADMMConsensus(gd)._graph_ops(v, 3)
    deg_d, ns_d, _ = vb_engine.ADMMConsensus(A)._graph_ops(v, 3)
    rel["admm_neighbour_sum"] = _rel(ns_s(v), ns_d(v))
    rel["admm_degree"] = _rel(deg_s, deg_d)
    del A, W, dense_keep
    # the combines launched twice on the same inputs: bit-equal
    repeat = {}
    for name in ("dsvb", "ring_link_drop", "gossip", "hierarchical"):
        topo, _ = _sparse_topology(name, GMMSensorConfig(), gd, n)
        topo = topo.to(dev)
        repeat[name] = torch.equal(topo.combine(v, t=3),
                                   topo.combine(v, t=3))
    a, b = (ns_s(v) for _ in range(2))
    repeat["admm_neighbour_sum"] = torch.equal(a, b)
    # 20 sparse iterations at 10,000 x 4096: fused against reference
    t0 = time.perf_counter()
    data = synthetic.paper_synthetic(n_nodes=n, n_per_node=N_PER_NODE,
                                     seed=SEED, dtype=np.float32)
    data_s = time.perf_counter() - t0
    inst = _sparse_instance(data, dev)
    del data
    agree = {}
    for name in ("dsvb", "dvb_admm_adaptive"):
        runs = {be: _sparse_run(name, inst, gd, be, SPARSE_VS_DENSE_ITERS,
                                dev) for be in ("fused", "reference")}
        f, r = runs["fused"].kl_mean, runs["reference"].kl_mean
        agree[name] = {"max_rel_kl_diff": float(((f - r).abs()
                                                 / r.abs()).max()),
                       "kl_last_fused": float(f[-1]),
                       "kl_last_reference": float(r[-1])}
        torch.testing.assert_close(f, r, rtol=1e-4, atol=1e-4)
    del inst
    # the same sparse session on the CPU and on the card (reference
    # backend, f64 data): the coins bit-equal, phi after one iteration
    cpu = torch.device("cpu")
    gs, _ = network.random_geometric_edges(SPARSE_CPU_N, seed=SEED)
    small = synthetic.paper_synthetic(n_nodes=SPARSE_CPU_N,
                                      n_per_node=SPARSE_CPU_T, seed=SEED)
    coins_equal = all(torch.equal(
        network.sparse_link_keep(network.link_generator(s, t, cpu),
                                 gs.n_undirected, p),
        network.sparse_link_keep(network.link_generator(s, t, dev),
                                 gs.n_undirected, p).cpu())
        for s, p in ((SEED, 0.2), (GOSSIP_SEED, 1.0 - GOSSIP_P))
        for t in range(4))
    cpu_vs_card = {}
    for name in ("dsvb", "ring_link_drop", "gossip", "hierarchical",
                 "dvb_admm_adaptive"):
        phis = []
        for d in (cpu, dev):
            prior = expfam.noninformative_prior(3, 2, beta0=0.1,
                                                w0_scale=10.0, device=d)
            sm = (GMMSensorConfig(), small.x, small.mask, prior, None, prior)
            st = _sparse_state(name, sm, gs, "reference", d)
            phis.append(vb_engine.vb_step(st).phi.cpu())
        cpu_vs_card[name] = _rel(phis[1], phis[0])
    emit("sparse_vs_dense_card", nodes=n, points_per_node=N_PER_NODE,
         links=g.n_undirected, combine_rel_diff=rel, repeat_bit_equal=repeat,
         n_iters=SPARSE_VS_DENSE_ITERS, fused_vs_reference=agree,
         data_seconds=data_s, cpu_nodes=SPARSE_CPU_N,
         cpu_points_per_node=SPARSE_CPU_T, coins_bit_equal=coins_equal,
         cpu_vs_card_rel_diff=cpu_vs_card)
    if max(rel.values()) > 1e-12 or not all(repeat.values()) \
            or not coins_equal or max(cpu_vs_card.values()) > 1e-12:
        raise AssertionError("sparse vs dense / repeat / CPU vs card failed")


# (case, `_sparse_topology` name, minibatch) of the round trips
CKPT_CASES = (
    ("sparse_diffusion_link_drop", "dsvb_link_drop", None),
    ("gossip", "gossip", None),
    ("hierarchical", "hierarchical", None),
    ("sparse_admm_adaptive_per_block_link_drop",
     "admm_adaptive_per_block_link_drop", None),
    ("stream_svrg", "dsvb",
     stream_lib.MinibatchSpec(CKPT_BATCH, SEED, "svrg")))


def _states_bit_equal(a, b) -> bool:
    fa, fb = ckpt._flatten(a), ckpt._flatten(b)
    return fa.keys() == fb.keys() and all(
        torch.equal(fa[k], fb[k]) if isinstance(fa[k], torch.Tensor)
        else fa[k] == fb[k] for k in fa)


def phase_session_checkpoint(dev) -> None:
    """Save at t = CKPT_A, restore, continue CKPT_B: bit-equal to the
    uninterrupted run on the card (fused backend) for five sessions; a
    card checkpoint (reference backend) restored on the CPU and continued
    there within 1e-9 of the card's uninterrupted run, the same coins;
    `latest_step` finds the newest file."""
    import shutil
    cpu = torch.device("cpu")
    data = synthetic.paper_synthetic(n_nodes=CKPT_N, n_per_node=CKPT_T,
                                     seed=SEED)
    g, _ = network.random_geometric_edges(CKPT_N, seed=SEED)
    insts = {d: _sparse_instance(data, d) for d in (dev, cpu)}
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    out = {}
    for case, topo_name, mb in CKPT_CASES:
        folder = os.path.join(CKPT_DIR, case)
        res = {}
        make = lambda be, d: _sparse_state(topo_name, insts[d], g, be, d, mb)
        whole, _ = vb_engine.vb_run(make("fused", dev), CKPT_A + CKPT_B)
        part, _ = vb_engine.vb_run(make("fused", dev), CKPT_A)
        path = ckpt.save(folder, part, step=CKPT_A)
        resumed = ckpt.restore(folder, make("fused", dev), step=CKPT_A)
        end, _ = vb_engine.vb_run(resumed, CKPT_B)
        ckpt.save(folder, end, step=CKPT_A + CKPT_B)
        res["card_bit_equal"] = (_states_bit_equal(resumed, part)
                                 and _states_bit_equal(end, whole))
        res["latest_step"] = ckpt.latest_step(folder)
        res["file_bytes"] = os.path.getsize(path)
        # the reference backend's card checkpoint continued on the CPU
        whole_r, _ = vb_engine.vb_run(make("reference", dev),
                                      CKPT_A + CKPT_B)
        part_r, _ = vb_engine.vb_run(make("reference", dev), CKPT_A)
        path_r = ckpt.save(os.path.join(folder, "reference.npz"), part_r)
        on_cpu = ckpt.restore(path_r, make("reference", cpu))
        end_cpu, _ = vb_engine.vb_run(on_cpu, CKPT_B)
        res["cpu_rel_diff"] = _rel(end_cpu.phi, whole_r.phi.cpu())
        out[case] = res
        if not res["card_bit_equal"] or res["latest_step"] != CKPT_A + CKPT_B \
                or not res["cpu_rel_diff"] <= 1e-9:
            raise AssertionError(f"checkpoint {case}: {res}")
    coins_equal = all(torch.equal(
        network.sparse_link_keep(network.link_generator(SEED, t, cpu),
                                 g.n_undirected, 0.2),
        network.sparse_link_keep(network.link_generator(SEED, t, dev),
                                 g.n_undirected, 0.2).cpu())
        for t in range(CKPT_A, CKPT_A + CKPT_B))
    emit("session_checkpoint", nodes=CKPT_N, points_per_node=CKPT_T,
         saved_at=CKPT_A, continued=CKPT_B, cases=out,
         coins_bit_equal=coins_equal)
    if not coins_equal:
        raise AssertionError("CPU and card link coins differ")


def phase_topology_scale(dev) -> None:
    """experiments/topology_scale.py --full on the card, each row beside
    BENCH_engine.json's (JAX on a CPU, 100/40/16 iterations: not a speed
    comparison; the KL strings are; the gossip coins differ by design)."""
    with open(os.path.join(HERE, "BENCH_engine.json")) as f:
        bench = json.load(f)["results"]
    t0 = time.perf_counter()
    rows, payload = topology_scale.run(full=True, device=dev)
    for name, us, derived in rows:
        key = name.removeprefix("topology_scale_")
        row = bench.get(name)
        kl = payload[key]["kl_vs_iters"]
        at = None
        if row is not None:
            n_b = int(re.search(r"n_iters=(\d+)", row["derived"]).group(1))
            if n_b <= len(kl):
                at = f"kl0={kl[0]:.1f} kl_final={kl[n_b - 1]:.2f}"
        match = None if at is None else at in row["derived"]
        emit("topology_scale", name=name, us_per_iter=us, derived=derived,
             square_tensor_ops=payload[key]["square_ops"],
             bench_derived=None if row is None else row["derived"],
             bench_us_per_call=None if row is None else row["us_per_call"],
             at_bench_iters=at, kl_strings_match_bench=match)
        # every row but gossip's (its coins differ by design) repeats the
        # reference's KL string
        if row is not None and "gossip" not in key and not match:
            raise AssertionError(f"{name}: {at} not in {row['derived']}")
    emit("topology_scale_done", rows=len(rows),
         seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# 7. the LM kernels against their plain versions
# ---------------------------------------------------------------------------
# the LM serving path: 4 requests, 2048-token prompts, 32 greedy tokens
LM_BATCH, LM_PROMPT, LM_NEW = 4, 2048, 32
# decode steps traced by the profiler after the timed ones
LM_PROFILE_STEPS = 4
# tests/test_kernels.py tolerances: flash by dtype; ssd at the sweep
# shapes (unit-scale outputs).  At Mamba-2's full prefill shape no absolute
# bar follows from those: |y| reaches tens, and the plain version's gates
# exp(cum_l - cum_l') take the difference of cumsums over its 256-step
# chunk, ~|cum| eps_f32 relative (the kernel's 64-step chunk is better
# conditioned).  There both are measured against an f64 evaluation of the
# same inputs (mamba2.ssd_chunked in float64): the kernel's max abs error,
# for y and for the state, must be at most twice the plain version's.
FLASH_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SSD_ATOL = 5e-5
SSD_VS_PLAIN = 2.0
# bf16: the kernel path and the non-kernel path round attention (or the
# SSD scan) differently (the kernels keep P and the sums in f32 and round
# the output once; the plain path rounds the softmax weights, the intra
# products and y_inter to bf16), and the difference compounds over 32-48
# residual layers into percents of the logits (a CPU run of the smoke
# widths at full depth: 2% for 32 attention layers, 5% for 48 SSD layers).
# No fixed bar follows from that, so both bf16 paths are measured against
# an f32 evaluation of the same weights (non-kernel path): the kernel
# path's relative L2 error of the last-position logits must be at most
# twice the non-kernel path's.  The tight check is the f32 one (rtol 1e-3).
LM_BF16_VS_PLAIN = 2.0
# the port's own device kernels, listed by name in the prefill profiles
# (the ssd wrapper launches three: ssd_states, ssd_pass, ssd_chunk_scan)
PROFILE_NAMED = ("flash_wgmma", "flash_simt", "ssd_")
# gmm_estep_nodes's time at the main path's call (f32 x, centred, no r)
# before its redesign: the one-block-per-node design that the
# shared-memory path keeps, on an NVIDIA H100 80GB HBM3 at 700 W; printed
# beside this run's
FIRST_DESIGN_GMM_MS = 0.067259202003479
# PR 12's kernel times at the same shapes (NVIDIA H100 80GB HBM3, 700 W;
# the first port's designs), printed beside this run's for comparison
PR12_FLASH_MS = 9.156639862060548
PR12_SSD_MS = 3.5714752197265627


def _flash_bound(B, S, Hq, Hkv, hd, window, elem):
    """(bound ms, by, flops, bytes) of one flash launch: the keys each
    query row reaches (causal, within the window), 4 hd flops per (row,
    key) (QK^T and PV); q, k, v read once, o written once."""
    i = np.arange(S)
    lo = np.maximum(0, i - window + 1) if window else np.zeros_like(i)
    flops = 4 * B * Hq * hd * int((i - lo + 1).sum())
    n_bytes = elem * (2 * B * S * Hq * hd + 2 * B * S * Hkv * hd)
    peak = PEAK_BF16_FLOP_PER_S if elem == 2 else PEAK_F32_FLOP_PER_S
    bound = {"bytes": n_bytes / PEAK_BYTES_PER_S * 1e3,
             "operations": flops / peak * 1e3}
    by = max(bound, key=bound.get)
    return bound[by], by, flops, n_bytes


def _ssd_bound(B, S, H, P, N, elem):
    """(bound ms, by, flops, bytes) of one ssd_scan launch at the kernel's
    own chunk L: per chunk and head, the causal half of C B^T (N each) and
    of the intra product (P each), C state and B^T x (N P each); x, Bm,
    Cm, dt, A read once, y and the final f32 state written once."""
    L = ssd_scan.KERNEL_CHUNK
    tri = L * (L + 1) // 2
    flops = B * H * (-(-S // L)) * 2 * (tri * N + tri * P + 2 * L * N * P)
    n_bytes = (elem * (2 * B * S * H * P + 2 * B * S * N) + 4 * B * S * H
               + 4 * H + 4 * B * H * P * N)
    peak = PEAK_BF16_FLOP_PER_S if elem == 2 else PEAK_F32_FLOP_PER_S
    bound = {"bytes": n_bytes / PEAK_BYTES_PER_S * 1e3,
             "operations": flops / peak * 1e3}
    by = max(bound, key=bound.get)
    return bound[by], by, flops, n_bytes


def _sdpa(q, k, v, window=0):
    """torch's scaled_dot_product_attention on the (B, S, H, hd) layout,
    k/v repeated to the query heads first (the library yardstick and the
    second oracle; never on the port's path)."""
    g = q.shape[2] // k.shape[2]
    kr, vr = (torch.repeat_interleave(a, g, dim=2).transpose(1, 2)
              for a in (k, v))
    if window:
        S = q.shape[1]
        i = torch.arange(S, device=q.device)[:, None]
        j = torch.arange(S, device=q.device)[None, :]
        out = torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), kr, vr, attn_mask=(j <= i) & (j > i - window))
    else:
        out = torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), kr, vr, is_causal=True)
    return out.transpose(1, 2)


def _flash_case(B, S, Hq, Hkv, hd, dtype, window, dev, gen, k=None,
                v=None, q=None):
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)
    q = rn(B, S, Hq, hd) if q is None else q
    k = rn(B, S, Hkv, hd) if k is None else k
    v = rn(B, S, Hkv, hd) if v is None else v
    got = ops.flash_attention(q, k, v, window=window)
    again = ops.flash_attention(q, k, v, window=window)
    want = flash_attention.flash_attention_plain(q, k, v, window=window)
    lib = _sdpa(q, k, v, window)
    torch.cuda.synchronize()
    atol = FLASH_ATOL[dtype]
    for ref, name in ((want, "plain"), (lib, "sdpa")):
        torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                                   atol=atol, msg=lambda m: f"{name}: {m}")
    if not torch.equal(got, again):
        raise AssertionError("flash_attention: two launches differ")
    return got, {"shape": [B, S, Hq, Hkv, hd], "dtype": str(dtype)[6:],
                 "window": window, "atol": atol,
                 "max_abs_err": float((got.float() - want.float()).abs()
                                      .max()),
                 "max_abs_err_sdpa": float((got.float() - lib.float()).abs()
                                           .max())}


def _ssd_inputs(B, S, H, P, N, dtype, dev, gen):
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)
    return (rn(B, S, H, P).to(dtype),
            torch.nn.functional.softplus(rn(B, S, H)),
            -torch.exp(rn(H) * 0.5), (rn(B, S, N) * 0.3).to(dtype),
            (rn(B, S, N) * 0.3).to(dtype))


def _ssd_case(B, S, H, P, N, chunk, dtype, dev, gen, full=False):
    """The kernel against its plain version: at atol SSD_ATOL, or (`full`)
    both against an f64 evaluation, the kernel's error within SSD_VS_PLAIN
    times the plain version's."""
    args = _ssd_inputs(B, S, H, P, N, dtype, dev, gen)
    y, h = ops.ssd_scan(*args, chunk=chunk)
    y2, h2 = ops.ssd_scan(*args, chunk=chunk)
    yp, hp = ssd_scan.ssd_scan_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    if not (torch.equal(y, y2) and torch.equal(h, h2)):
        raise AssertionError("ssd_scan: two launches differ")
    case = {"shape": [B, S, H, P, N], "chunk": chunk,
            "dtype": str(dtype)[6:],
            "max_abs_err": float(max((y.float() - yp.float()).abs().max(),
                                     (h - hp).abs().max())),
            "max_abs_y": float(yp.float().abs().max())}
    if not full:
        for name, g, w in (("y", y, yp), ("state", h, hp)):
            torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                       atol=SSD_ATOL,
                                       msg=lambda m: f"ssd {name}: {m}")
        case["atol"] = SSD_ATOL
        return case
    y64, h64 = mamba2.ssd_chunked(*(a.double() for a in args), chunk)
    for name, g, w, ref in (("y", y, yp, y64), ("state", h, hp, h64)):
        err_k = float((g.double() - ref).abs().max())
        err_p = float((w.double() - ref).abs().max())
        case[f"{name}_err_vs_f64"] = {"kernel": err_k, "plain": err_p}
        if err_k > SSD_VS_PLAIN * err_p:
            raise AssertionError(f"ssd {name} at {case['shape']} "
                                 f"{case['dtype']}: kernel error vs f64 "
                                 f"{err_k} > {SSD_VS_PLAIN} x plain {err_p}")
    case["bar_ratio_vs_plain"] = SSD_VS_PLAIN
    return case


def phase_lm_kernel_vs_plain(dev) -> dict:
    gen = torch.Generator(dev).manual_seed(0)
    flash = []
    for B, S, Hq, Hkv, hd in ((2, 64, 4, 2, 32), (1, 128, 2, 1, 64),
                              (2, 96, 4, 4, 16), (1, 256, 8, 2, 128),
                              (1, 1000, 8, 1, 128)):
        for dtype in (torch.float32, torch.bfloat16):
            for window in (0, 32):
                flash.append(_flash_case(B, S, Hq, Hkv, hd, dtype, window,
                                         dev, gen)[1])
    # causality: keys and values past S/2 do not move the first half
    q, k, v = (torch.randn(1, 64, 2, 32, generator=gen, device=dev)
               for _ in range(3))
    out1 = _flash_case(1, 64, 2, 2, 32, torch.float32, 0, dev, gen, k, v,
                       q)[0]
    k2, v2 = k.clone(), v.clone()
    k2[:, 32:], v2[:, 32:] = 99.0, -99.0
    out2 = ops.flash_attention(q, k2, v2)
    torch.testing.assert_close(out1[:, :32], out2[:, :32], rtol=0,
                               atol=1e-5)
    causality = float((out1[:, :32] - out2[:, :32]).abs().max())
    # the Yi-6B prefill shape
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        case = _flash_case(LM_BATCH, LM_PROMPT, 32, 4, 128, dtype, 0, dev,
                           gen)[1]
        flash.append(case)
        main[dtype] = case["max_abs_err"]
    ssd = [_ssd_case(*shape, torch.float32, dev, gen)
           for shape in ((2, 64, 4, 16, 8, 16), (1, 128, 2, 32, 16, 32),
                         (2, 64, 2, 8, 4, 64), (1, 96, 3, 16, 8, 32))]
    ssd_main = {}
    for dtype in (torch.float32, torch.bfloat16):
        case = _ssd_case(LM_BATCH, LM_PROMPT, 32, 64, 128, 256, dtype, dev,
                         gen, full=True)
        ssd.append(case)
        ssd_main[dtype] = case["max_abs_err"]
    emit("lm_kernel_vs_plain", flash_attention=flash,
         causality_max_abs_diff=causality, ssd_scan=ssd,
         launches_bit_equal=True)
    return {"flash_attention": main[torch.bfloat16],
            "ssd_scan": ssd_main[torch.bfloat16]}


# ---------------------------------------------------------------------------
# 8. the LM serving path at full width
# ---------------------------------------------------------------------------
def _requests(cfg, n_new, seed=0):
    rng = np.random.default_rng(seed)
    return [engine.Request(rng.integers(0, cfg.vocab_size, LM_PROMPT)
                           .astype(np.int32), n_new)
            for _ in range(LM_BATCH)]


def _last_logits(cfg, lm, toks, use_kernels):
    logits, _ = engine.make_prefill_step(cfg, use_kernels=use_kernels)(
        lm, toks)
    return logits[:, -1].float()


def _rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm())


def _f32_logits(cfg, lm, toks):
    """Last-position logits of the same weights evaluated in f32 on the
    non-kernel path (the bf16 paths' common reference)."""
    c32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    lm32 = lm_model.LM(c32, device=toks.device, init=False)
    with torch.no_grad():
        for p32, p in zip(lm32.parameters(), lm.parameters()):
            p32.copy_(p)
    with torch.inference_mode():
        out = _last_logits(c32, lm32, toks, False)
    del lm32
    torch.cuda.empty_cache()
    return out


def _f32_depth4(cfg, dev) -> dict:
    """The published widths at depth 4 in f32: kernel path against the
    non-kernel path, last-position logits at rtol 1e-3 and the first 8
    greedy tokens equal."""
    c4 = cfg.replace(n_layers=4, param_dtype="float32",
                     compute_dtype="float32")
    lm = lm_model.init_params(c4, torch.Generator(dev).manual_seed(1),
                              device=dev)
    reqs = _requests(c4, 8, seed=1)
    toks = torch.as_tensor(admission.right_aligned_batch(
        [r.prompt for r in reqs]), dtype=torch.int64, device=dev)
    with torch.inference_mode():
        got = _last_logits(c4, lm, toks, True)
        want = _last_logits(c4, lm, toks, False)
    # rtol 1e-3 per logit; logits near zero are held to 1e-3 of the
    # logits' RMS (an absolute floor on the scale of the vector)
    atol = 1e-3 * float(want.pow(2).mean().sqrt())
    torch.testing.assert_close(got, want, rtol=1e-3, atol=atol)
    outs = [engine.Engine(c4, lm, max_seq=LM_PROMPT + 8, use_kernels=uk,
                          device=dev).generate(reqs) for uk in (True, False)]
    same = all(np.array_equal(a, b) for a, b in zip(*outs))
    if not same:
        raise AssertionError(f"{cfg.name} depth 4 f32: greedy tokens of "
                             f"the kernel and non-kernel paths differ")
    return {"layers": 4, "dtype": "float32", "logits_rtol": 1e-3,
            "logits_atol": atol,
            "max_abs_diff": float((got - want).abs().max()),
            "rel_l2": _rel_l2(got, want), "greedy_8_equal": same}


def phase_lm_serve(arch: str, kernel: str, dev) -> dict:
    """The port's LM serving path for a published config at full width
    and depth (bf16): Engine.generate with the kernels, launch counts
    around it, then its timings and the non-kernel comparison."""
    cfg = get_config(arch)
    t0 = time.perf_counter()
    lm = lm_model.init_params(cfg, torch.Generator(dev).manual_seed(0),
                              device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reqs = _requests(cfg, LM_NEW)
    # warm-up outside the window (library handles, the kernels' load)
    engine.Engine(cfg, lm, max_seq=64 + 2, use_kernels=True,
                  device=dev).generate([engine.Request(r.prompt[:64], 2)
                                        for r in reqs])
    eng = engine.Engine(cfg, lm, max_seq=LM_PROMPT + LM_NEW,
                        use_kernels=True, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()                               # the path's window
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = read_launches()                    # read just after
    peak = torch.cuda.max_memory_allocated()
    st = eng.stats()
    ok_tokens = all(o.shape == (LM_PROMPT + LM_NEW,) and o.min() >= 0
                    and o.max() < cfg.vocab_size for o in outs)
    want = {k: 0 for k in launches}
    want[kernel] = cfg.n_layers
    if launches != want or st.slices != LM_NEW or not ok_tokens:
        raise AssertionError(f"{arch}: launches {launches} (want {want}), "
                             f"{st.slices} decode steps, tokens ok "
                             f"{ok_tokens}")

    # prefill alone, then LM_NEW decode steps on its cache (host clock,
    # synchronised; each step ends in the host read of its token, as in
    # the engine)
    toks = torch.as_tensor(admission.right_aligned_batch(
        [r.prompt for r in reqs]), dtype=torch.int64, device=dev)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = engine.make_prefill_step(cfg, use_kernels=True)(
            lm, toks)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        finite = bool(torch.isfinite(logits).all())
        got = logits[:, -1].float()
        end = LM_PROMPT + LM_NEW
        state = {"cache": engine._splice_cache(cfg, lm_model.init_cache(
            cfg, LM_BATCH, end + LM_PROFILE_STEPS, torch.float32,
            device=dev), cache, LM_PROMPT),
            "cur": engine._sample(logits, 0.0, None)}
        del cache, logits
        decode = engine.make_decode_step(cfg)

        def steps(first, last):
            for t in range(first, last):
                out, state["cache"] = decode(lm, state["cur"],
                                             state["cache"], t)
                state["cur"] = engine._sample(out, 0.0, None)
                state["cur"].cpu()

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps(LM_PROMPT, end)
        decode_ms = (time.perf_counter() - t0) * 1e3 / LM_NEW
        prof_decode = profile_window(
            lambda: steps(end, end + LM_PROFILE_STEPS))
        del state
        prof_prefill = profile_window(lambda: engine.make_prefill_step(
            cfg, use_kernels=True)(lm, toks), named=PROFILE_NAMED)
        want_logits = _last_logits(cfg, lm, toks, False)
    ref = _f32_logits(cfg, lm, toks)
    if not finite:
        raise AssertionError(f"{arch}: non-finite prefill logits")
    bf16 = {"rel_l2_kernel_vs_plain": _rel_l2(got, want_logits),
            "rel_l2_kernel_vs_f32": _rel_l2(got, ref),
            "rel_l2_plain_vs_f32": _rel_l2(want_logits, ref),
            "bar_ratio": LM_BF16_VS_PLAIN,
            "argmax_equal_share": float((got.argmax(-1) == want_logits
                                         .argmax(-1)).float().mean())}
    if bf16["rel_l2_kernel_vs_f32"] > (LM_BF16_VS_PLAIN
                                       * bf16["rel_l2_plain_vs_f32"]):
        raise AssertionError(f"{arch}: bf16 kernel path less accurate than "
                             f"the non-kernel path: {bf16}")
    del lm, want_logits, got, ref
    torch.cuda.empty_cache()
    f32 = _f32_depth4(cfg, dev)
    torch.cuda.empty_cache()
    return {"arch": arch, "layers": cfg.n_layers, "dtype": cfg.param_dtype,
            "batch": LM_BATCH, "prompt": LM_PROMPT, "new_tokens": LM_NEW,
            "init_s": init_s, "launches": launches,
            "decode_steps": st.slices, "finite": finite,
            "generate_s": gen_s,
            "generate_tokens_per_s": LM_BATCH * LM_NEW / gen_s,
            "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
            "decode_tokens_per_s": LM_BATCH / decode_ms * 1e3,
            "profile_prefill": prof_prefill,
            "profile_decode": {"steps": LM_PROFILE_STEPS, **prof_decode},
            "max_memory_allocated": peak,
            "vs_non_kernel_bf16": bf16,
            "f32_depth4": f32}


def _time_flash(dev) -> dict:
    """flash_attention at the Yi-6B prefill shape: the kernel (CUDA events
    after a warm-up), its plain version and SDPA, beside the bound."""
    gen = torch.Generator(dev).manual_seed(2)
    shape = (LM_BATCH, LM_PROMPT, 32, 4, 128)
    B, S, Hq, Hkv, hd = shape
    q, k, v = (torch.randn(B, S, h, hd, generator=gen, device=dev)
               .to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
    ms = time_ms(lambda: ops.flash_attention(q, k, v), 10)
    plain_ms = time_ms(lambda: flash_attention.flash_attention_plain(
        q, k, v), 3)
    g = Hq // Hkv
    kr, vr = (torch.repeat_interleave(a, g, dim=2).transpose(1, 2)
              for a in (k, v))
    qt = q.transpose(1, 2)
    library_ms = time_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(qt, kr, vr,
                                                       is_causal=True), 10)
    bound, by, flops, n_bytes = _flash_bound(*shape, 0, 2)
    return {"shape": list(shape), "dtype": "bfloat16", "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound, "bound_by": by, "flops": flops,
            "bytes": n_bytes, "achieved_TFLOPs": flops / ms / 1e9,
            "achieved_GBps": n_bytes / ms / 1e6,
            "library_TFLOPs": flops / library_ms / 1e9,
            "pr12_ms": PR12_FLASH_MS,
            "pr12_TFLOPs": flops / PR12_FLASH_MS / 1e9}


def _time_ssd(dev) -> dict:
    """ssd_scan at the Mamba-2 370M prefill shape (bf16 x): the kernel
    (CUDA events after a warm-up) and its plain version, beside the
    bound.  No single PyTorch call computes the SSD scan."""
    gen = torch.Generator(dev).manual_seed(3)
    shape = (LM_BATCH, LM_PROMPT, 32, 64, 128)
    args = _ssd_inputs(*shape, torch.bfloat16, dev, gen)
    ms = time_ms(lambda: ops.ssd_scan(*args, chunk=256), 10)
    plain_ms = time_ms(lambda: ssd_scan.ssd_scan_plain(*args, chunk=256), 3)
    bound, by, flops, n_bytes = _ssd_bound(*shape, 2)
    return {"shape": list(shape), "dtype": "bfloat16", "chunk": 256,
            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound, "bound_by": by, "flops": flops,
            "bytes": n_bytes, "achieved_GBps": n_bytes / ms / 1e6,
            "achieved_TFLOPs": flops / ms / 1e9,
            "scratch_bytes": ssd_scan.scratch_bytes(*shape),
            "pr12_ms": PR12_SSD_MS,
            "pr12_GBps": n_bytes / PR12_SSD_MS / 1e6}


def main():
    dev_info = phase_device()
    ptxas = phase_build()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    inst = _instance(N_NODES, N_PER_NODE, dev)
    cfg, x, mask, adj = inst[:4]
    torch.cuda.synchronize()
    emit("main_path_setup", nodes=N_NODES, points_per_node=N_PER_NODE,
         K=cfg.K, D=cfg.D, edges=int(adj.sum()) // 2,
         data_bytes=x.numel() * 4 + mask.numel() * 4,
         seconds=round(time.perf_counter() - t0, 3))
    phase_kernel_vs_plain(x, mask, dev)
    mp = phase_main_path(inst, dev, ptxas["gmm_estep"])
    sm = phase_smem_path(inst, dev)
    phase_small_vs_cpu(dev)
    phase_profile(inst, dev)
    phase_engine_remainder(inst, dev)
    phase_stream_main_path(inst, dev)
    fleet = phase_vb_serve_fleet(inst, dev)
    del inst, x, mask
    torch.cuda.empty_cache()
    sparse = phase_sparse_main_path(dev)
    torch.cuda.empty_cache()
    phase_sparse_vs_dense_card(dev)
    torch.cuda.empty_cache()
    phase_session_checkpoint(dev)
    phase_topology_scale(dev)
    wide = phase_gmm_wide_kernel_vs_plain(dev)
    sec5 = phase_paper_sec5(dev)
    phase_stream_cpu_vs_card(dev)
    phase_stream_scaled_mask_kernel(dev)
    phase_streaming_experiments(dev)
    phase_model_zoo(dev)

    lm_err = phase_lm_kernel_vs_plain(dev)
    yi = phase_lm_serve("yi_6b", "flash_attention", dev)
    yi["flash_attention"] = fa = _time_flash(dev)
    yi["flash_share_of_prefill"] = yi["layers"] * fa["ms"] / yi["prefill_ms"]
    emit("lm_serve_yi_6b", **yi)
    mb = phase_lm_serve("mamba2_370m", "ssd_scan", dev)
    mb["ssd_scan"] = sd = _time_ssd(dev)
    mb["ssd_share_of_prefill"] = mb["layers"] * sd["ms"] / mb["prefill_ms"]
    emit("lm_serve_mamba2_370m", **mb)

    print(json.dumps({"kernels": [{
        "name": "gmm_estep_nodes", "route": "cuda",
        "source": "src/repro_torch/csrc/gmm_estep.cu",
        "replaces": "src/repro/kernels/gmm_estep.py:118",
        # the main path's launches, the sparse main path's and the
        # serving fleets' (the register path runs all three), the worst
        # error of the three shapes
        "launches": mp["launches"] + sparse["launches"]
        + fleet["launches"],
        "max_abs_err": max(mp["max_abs_err"], sparse["max_abs_err"],
                           fleet["max_abs_err"]),
        "max_err": max(mp["max_abs_err"], sparse["max_abs_err"],
                       fleet["max_abs_err"]),
        "ms": mp["ms"],
        "plain_ms": mp["plain_ms"], "bound_ms": mp["bound_ms"],
        "bound_by": mp["bound_by"], "library_ms": None}, {
        # the same function's shared-memory path: launched by the
        # over-complete mixture (K=8, D=2), timed at SMEM_TIMED
        "name": "gmm_estep_nodes_smem", "route": "cuda",
        "source": "src/repro_torch/csrc/gmm_estep.cu",
        "replaces": "src/repro/kernels/gmm_estep.py:118",
        "launches": sm["launches"], "max_abs_err": sm["max_abs_err"],
        "max_err": sm["max_abs_err"], "ms": sm["ms"],
        "plain_ms": sm["plain_ms"], "bound_ms": sm["bound_ms"],
        "bound_by": sm["bound_by"], "library_ms": None}, {
        # the same function's wide path (D > 8): launched on the Sec. V
        # path (Table II, Fig. 13), timed at WIDE_DEPLOY
        "name": "gmm_estep_nodes_wide", "route": "cuda",
        "source": "src/repro_torch/csrc/gmm_estep.cu",
        "replaces": "src/repro/kernels/gmm_estep.py:118",
        "launches": sec5["wide_launches"],
        "max_abs_err": wide["max_abs_err"], "max_err": wide["max_abs_err"],
        "ms": wide["ms"], "plain_ms": wide["plain_ms"],
        "bound_ms": wide["bound_ms"], "bound_by": wide["bound_by"],
        "library_ms": None}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:84",
        "launches": yi["launches"]["flash_attention"],
        "max_abs_err": lm_err["flash_attention"],
        "max_err": lm_err["flash_attention"], "ms": fa["ms"],
        "plain_ms": fa["plain_ms"], "bound_ms": fa["bound_ms"],
        "bound_by": fa["bound_by"], "library_ms": fa["library_ms"]}, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:74",
        "launches": mb["launches"]["ssd_scan"],
        "max_abs_err": lm_err["ssd_scan"], "max_err": lm_err["ssd_scan"],
        "ms": sd["ms"], "plain_ms": sd["plain_ms"],
        "bound_ms": sd["bound_ms"], "bound_by": sd["bound_by"],
        "library_ms": None}]}), flush=True)
    print(dev_info["smi"], flush=True)
    print(json.dumps({"ok": True, "device": dev_info["info"]}), flush=True)


if __name__ == "__main__":
    main()
