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
6t. telemetry_main_path — 50 fused dSVB iterations of the main path with
   repro_torch.telemetry off, host-enabled, and host plus taps: ms per
   iteration and host us a gmm_estep call (medians of 7 runs, the modes
   interleaved), device kernels and copies per iteration over 20
   profiled iterations (in the loop and over the run), CUDA-runtime
   synchronise calls and device-to-host copies inside the loop, the
   count of kernel/gmm_estep_nodes spans beside the launches and their
   mean host time;
   phi bit-equal in the three modes, equal kernels in the loop off and
   host-enabled, vb_run/kl_mean equal to the run's kl_mean, no
   synchronise call or device-to-host copy added in the loop;
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
   `random_geometric_edges(100000)` (its build seconds, under 30 s;
   the host data, `paper_synthetic`'s ~75-100 s of numpy, made by a
   worker process started after the device phase, so it overlaps the
   phases before this one: the same function and seed, the same bytes):
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
   and its device time against its bound; peak memory; then group C
   again with telemetry and taps on (each tenant bit-equal to the run
   with them off, ms per fleet iteration off and on, one driver/slice
   span a slice, the five driver gauges), and the `vb_serve` launcher
   in-process with --trace and --metrics at a small size (its files
   load as JSON and parse as Prometheus text);
6n. the mesh executor (`run_vb(executor=)`, `VBService(executor=)`)
   under a one-rank NCCL group from `admission.data_axis_mesh()` (a
   HashStore, no port; a failed initialisation fails the run):
   mesh_main_path — dSVB (Diffusion: all-gather), RingDiffusion with
   link_drop 0.2 (the ring exchange), adaptive dVB-ADMM with per_block
   (psums) and cVB (FusionCenter: pmean) at the main path's size, 20
   fused iterations each: phi, the KLs, the consensus error and the ADMM
   diagnostics bit-equal to the single-array executor, one gmm_estep
   launch an iteration, ms an iteration with and without the executor
   (median of 7 runs in turns, with the range), device and NCCL kernels
   an iteration (profiled), and gmm_estep on row slices of the main
   shape bit-equal to the same rows of the whole launch; mesh_serve_fleet
   (after vb_serve_fleet) — group C under the executor, each tenant
   bit-equal to the single-array fleet's result and to its solo run, ms
   per fleet iteration against the single-array fleet's (3 runs in
   turns); mesh_sparse (after sparse_main_path) — sparse dSVB at 100,000
   x 4096, 5 iterations, bit-equal to the single-array run, ms an
   iteration and peak memory of both;
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
9. the last LM families and LM training: lm_flash_hd256 (flash_attention
   at RecurrentGemma-2B's MQA shape, head_dim 256, window 2048, bf16,
   against its plain version and SDPA; its time beside the plain
   version's, SDPA's and the operations bound; ptxas's registers and
   spills); lm_serve_recurrentgemma_2b, lm_serve_granite_moe_3b_a800m and
   lm_serve_qwen2_vl_2b (phase 8 for each, at full depth; one flash
   launch an attention layer; Qwen2-VL's prompts start with its 256 stub
   positions); lm_train_yi_6b (`Trainer`, allreduce, Yi-6B at published
   width cut to 8 of its 32 layers, bf16, remat, Batcher batches of 4 x
   1024, warmup 2, 10 steps: ms a step (median of steps 3-10), tokens/s,
   peak memory, loss and grad norm each step, the loss finite, no kernel
   launched); lm_train_mamba2_370m (the whole published model in
   allreduce, diffusion and ADMM, the consensus modes over a one-rank
   NCCL group: the same numbers, consensus_residual, and the
   collectives and bytes a step); lm_train_small_vs_cpu (every ARCH_ID's
   f32 smoke config, two allreduce steps on the card against the CPU
   from the same state: loss 1e-5 relative, each parameter tensor 1e-4
   relative L2 error);
10. LM sharding on a (1, 1) ("data", "model") device mesh (one card: a
   one-rank NCCL group from `launch.mesh.make_test_mesh(1, 1)`, the same
   DTensor code as a larger mesh): lm_mesh_serve_yi_6b /
   lm_mesh_serve_mamba2_370m (`Engine(mesh=)` on the published configs
   at full width and depth in bf16 with the kernels, 4 x 2048-token
   prompts, 32 greedy tokens: tokens equal and the last prefill logits
   bit-equal to the unsharded Engine on the same parameters; one kernel
   launch a layer in a prefill, each on its rank's shard through
   `local_map`; prefill ms, ms a decode step and peak memory of both
   engines); lm_mesh_train (Mamba-2 370M, `Trainer(mesh=)` in allreduce
   and ADMM, 3 steps on the Batcher's 4 x 1024 batches: the state
   bit-equal to the unsharded Trainer's, ms a step of both; then a
   save/restore round trip of a mesh Trainer in both modes, on the bf16
   smoke config: the whole model's compressed file takes minutes);
11. launch_dryrun (after lm_mesh_serve_yi_6b) — the allocation-free dry
   run (`launch.dryrun`, in a worker process started with the script,
   each case as rank 0 of a fake world of 256 or 512 ranks on a
   card-typed mesh): launch_dryrun_case lines for Yi-6B train_4k on
   (16, 16) in allreduce and ADMM, Yi-6B and Mamba-2 370M prefill_32k on
   (16, 16) with the kernels, Grok-1 314B train_4k on (2, 16, 16) (Tc,
   Tm, Tcoll against H100 peaks, the bottleneck, useful FLOPs, argument
   and temp GiB a card, collective counts); then Yi-6B's prefill at
   lm_mesh_serve's shape on a fake (1, 1) world against the real
   `Engine(mesh=)` prefill: parameter bytes equal, FLOPs equal to the
   same counting mode over the real prefill, the kernels' op counts
   equal to its launches, no card memory allocated by the dry run; the
   measured prefill ms against max(Tc, Tm) and the predicted temp bytes
   against the prefill's peak memory;

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
import torch.distributed as dist  # noqa: E402

from repro_torch import telemetry  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.configs.gmm_sensor import GMMSensorConfig  # noqa: E402
from repro_torch.core import algorithms, expfam, gmm, network  # noqa: E402
from repro_torch.core import engine as vb_engine  # noqa: E402
from repro_torch.core import refperm  # noqa: E402
from repro_torch.core.engine import kl_to_reference  # noqa: E402
from repro_torch.core.model import GMMModel  # noqa: E402
from repro_torch.data import stream as stream_lib  # noqa: E402
from repro_torch.data import synthetic, tokens  # noqa: E402
from repro_torch.dist import collectives, sharding  # noqa: E402
from repro_torch.experiments import paper_figures, streaming  # noqa: E402
from repro_torch.experiments import topology_scale  # noqa: E402
from repro_torch.kernels import build, gmm_estep, ops  # noqa: E402
from repro_torch.kernels import flash_attention, ssd_scan  # noqa: E402
from repro_torch.launch import hlo_analysis  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import hmm, mamba2, ppca  # noqa: E402
from repro_torch.models import model as lm_model  # noqa: E402
from repro_torch.serving import admission, engine  # noqa: E402
from repro_torch.serving import vb_service  # noqa: E402
from repro_torch.training import train_step  # noqa: E402
from repro_torch.training.trainer import Trainer  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet; one source, launch.hlo_analysis): HBM
# bandwidth, f32 outside the tensor cores, bf16 on the tensor cores
# (dense), f64 on the tensor cores (DMMA, the wide gmm_estep path's log
# rho and statistics)
PEAK_BYTES_PER_S = hlo_analysis.HBM_BW
PEAK_F32_FLOP_PER_S = hlo_analysis.PEAK_F32_FLOPS
PEAK_BF16_FLOP_PER_S = hlo_analysis.PEAK_FLOPS
PEAK_F64_TC_FLOP_PER_S = hlo_analysis.PEAK_F64_TC_FLOPS

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
    # the flash instances, hd 256's above all (its accumulator spilled
    # before the two warpgroups split the output columns)
    flash = tables["flash_attention"]
    if ({(r["kernel"], r.get("hd")) for r in flash} != {
            (k, hd) for k in ("flash_wgmma_kernel", "flash_simt_kernel")
            for hd in flash_attention.HEAD_DIMS}
            or any(r.get("spill_stores", 0) or r.get("spill_loads", 0)
                   for r in flash)):
        raise AssertionError(f"the flash kernels spill (or an instance was "
                             f"not found): {flash}")
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
def profile_window(fn, named=(), counts=False) -> dict:
    """Trace fn() (then a synchronize): device-busy time by kernel against
    the host wall clock (the profiler's own overhead inflates the wall
    time, so the idle share is an upper bound).  Only device-side events
    count (kernels, copies, sets): a host op such as aten::mm reports its
    kernels' time as its own device time too, and CUPTI's "Command Buffer
    Full" marks the host waiting on a full launch queue, not device
    work, nor is the device-side mirror of a host range (a user
    annotation: the port's telemetry spans are profiler ranges while
    the profiler records).  Kernels whose name holds one of the strings
    in `named` are
    also listed on their own, whatever their rank; `counts` adds every
    device event's count by name."""
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
              and not e.is_user_annotation
              and e.key != "Command Buffer Full"]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms,
           "kernels_launched": sum(e.count for e in events),
           "top": [_kernel_row(e) for e in top],
           "named": [_kernel_row(e) for e in events
                     if any(n in e.key for n in named)]}
    if counts:
        out["counts"] = {e.key: e.count for e in events}
    return out


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
# 6t. telemetry on the main path (repro_torch.telemetry)
# ---------------------------------------------------------------------------
TELEMETRY_ITERS = 50
TELEMETRY_PROFILE_ITERS = 20
# interleaved runs a mode: the host's clock moves ms an iteration by up
# to ~2x from run to run on this path (PERF.md), more than telemetry
# costs
TELEMETRY_REPS = 7
TELEMETRY_CALLS = 200
TELEMETRY_MODES = ("off", "host", "taps")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def _telemetry_mode(mode: str) -> None:
    """Telemetry off and empty; then host telemetry on ("host"), or host
    telemetry and taps ("taps")."""
    telemetry.disable()
    telemetry.taps.disable()
    telemetry.reset()
    if mode != "off":
        telemetry.enable()
    if mode == "taps":
        telemetry.taps.enable()


def _is_copy(e) -> bool:
    return e.name.startswith(("Memcpy", "Memset"))


def _profile_loop(fn) -> dict:
    """Trace fn() with each engine iteration marked (`_iteration` under a
    `record_function`, which the profiler mirrors on the device's
    timeline): device kernels and copies over the whole run and inside
    the loop (from the first iteration's device work to the last one's),
    kernels by name, the CUDA-runtime synchronise calls the host made
    between the first iteration's start and the last one's end, and the
    device-to-host copies inside the loop."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    inner = vb_engine._iteration

    def marked(*a, **k):
        with record_function("vb_iteration"):
            return inner(*a, **k)

    vb_engine._iteration = marked
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        vb_engine._iteration = inner
    events = list(prof.events())

    def span_of(es):
        return (min(e.time_range.start for e in es),
                max(e.time_range.end for e in es))

    marks = [e for e in events if e.name == "vb_iteration"]
    host_marks = [e for e in marks if e.device_type == DeviceType.CPU]
    dev_marks = [e for e in marks if e.device_type == DeviceType.CUDA]
    lo, hi = span_of(host_marks)
    d_lo, d_hi = span_of(dev_marks)
    host = [e for e in events if e.device_type == DeviceType.CPU
            and lo <= e.time_range.start <= hi]
    # the device-side mirrors of host ranges (the iteration marks, the
    # telemetry spans) are no device work
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation
              and e.name != "Command Buffer Full"]
    in_loop = [e for e in device if d_lo <= e.time_range.start <= d_hi]
    kernels = [e for e in device if not _is_copy(e)]
    gmm = [e for e in kernels if "gmm_estep" in e.name]
    by_name = {}
    for e in kernels:
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0) + 1
    return {
        "iterations_marked": len(host_marks),
        "iterations_marked_on_device": len(dev_marks),
        "kernels": len(kernels),
        "kernels_in_loop": sum(not _is_copy(e) for e in in_loop),
        "copies": len(device) - len(kernels),
        "copies_in_loop": sum(_is_copy(e) for e in in_loop),
        "copies_by_kind": {k: sum(e.name == k for e in device)
                           for k in sorted({e.name for e in device
                                            if _is_copy(e)})},
        "by_name": by_name,
        "runtime_launches_in_loop": sum(e.name == "cudaLaunchKernel"
                                        for e in host),
        "sync_calls_in_loop": {n: sum(e.name == n for e in host)
                               for n in SYNC_CALLS},
        "d2h_copies_in_loop": sum("DtoH" in e.name for e in in_loop),
        "gmm_estep_calls": len(gmm),
        "gmm_estep_device_ms_per_call": sum(
            e.time_range.elapsed_us() for e in gmm) / 1e3 / len(gmm)}


def _kernel_call_args(inst, phi):
    """FusedBackend's gmm_estep_nodes call on the main path's data at the
    terms of the iterate `phi` (f32 x, centred, no r)."""
    cfg, x, mask = inst[:3]
    q = expfam.unpack_natural(phi, cfg.K, cfg.D)
    shift = q.m.float().contiguous()
    terms = [t.contiguous() for t in gmm.estep_terms(q, torch.float32,
                                                     shift=shift)]
    return (x, mask, *terms, float(N_NODES)), shift


def _call_host_us(args, shift) -> float:
    """Host microseconds a gmm_estep_nodes call over TELEMETRY_CALLS calls
    queued back to back (the host, not the 0.03 ms kernel, sets the
    pace)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TELEMETRY_CALLS):
        ops.gmm_estep_nodes(*args, shift=shift, return_r=False)
    host = (time.perf_counter() - t0) * 1e6 / TELEMETRY_CALLS
    torch.cuda.synchronize()
    return host


def phase_telemetry_main_path(inst, dev) -> dict:
    """Telemetry off, host-enabled and with taps on the main path (module
    docstring, 6t)."""
    t_phase = time.perf_counter()

    def run(n_iters=TELEMETRY_ITERS):
        return _estimate("dsvb", *inst, "fused", n_iters, dev)

    # ms per iteration and host us a kernel call: the modes interleaved,
    # run by run
    times = {mode: [] for mode in TELEMETRY_MODES}
    call_us = {mode: [] for mode in TELEMETRY_MODES}
    args, shift = _kernel_call_args(inst, run(2).phi)
    for mode in TELEMETRY_MODES:
        _telemetry_mode(mode)
        run(2)                                              # warm
    for _ in range(TELEMETRY_REPS):
        for mode in TELEMETRY_MODES:
            _telemetry_mode(mode)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times[mode].append((time.perf_counter() - t0) * 1e3
                               / TELEMETRY_ITERS)
            call_us[mode].append(_call_host_us(args, shift))
    out, phi = {}, {}
    for mode in TELEMETRY_MODES:
        _telemetry_mode(mode)
        before = ops.gmm_estep_nodes.launches
        res = run()
        torch.cuda.synchronize()
        launched = ops.gmm_estep_nodes.launches - before
        phi[mode] = res.phi
        rec = {"ms_per_iter": float(np.median(times[mode])),
               "ms_per_iter_runs": times[mode],
               "kernel_call_host_us": float(np.median(call_us[mode])),
               "kernel_call_host_us_runs": call_us[mode],
               "launches": launched}
        if mode != "off":
            ts, kl = telemetry.taps.series("vb_run/kl_mean")
            rec["series_kl_bit_equal"] = bool(np.array_equal(
                kl, res.kl_mean.cpu().numpy())) and ts.tolist() == list(
                    range(TELEMETRY_ITERS))
            rec["taps"] = telemetry.taps.counts()
            # the host's side of each call: the kernel/<name> spans
            spans = [e["dur"] for e in
                     telemetry.tracer().to_chrome()["traceEvents"]
                     if e["name"] == "kernel/gmm_estep_nodes"]
            rec["kernel_span_count"] = len(spans)
            rec["kernel_span_mean_ms"] = (sum(spans) / len(spans) / 1e3
                                          if spans else None)
        telemetry.reset()
        prof = _profile_loop(lambda: run(TELEMETRY_PROFILE_ITERS))
        telemetry.reset()
        rec.update(prof, kernels_per_iter=prof["kernels"]
                   / TELEMETRY_PROFILE_ITERS,
                   kernels_in_loop_per_iter=prof["kernels_in_loop"]
                   / TELEMETRY_PROFILE_ITERS,
                   copies_per_iter=prof["copies"] / TELEMETRY_PROFILE_ITERS)
        out[mode] = rec
    _telemetry_mode("off")
    for mode in ("host", "taps"):
        names = set(out[mode]["by_name"]) | set(out["off"]["by_name"])
        out[mode]["kernels_vs_off"] = {
            n: out[mode]["by_name"].get(n, 0) - out["off"]["by_name"].get(
                n, 0) for n in names
            if out[mode]["by_name"].get(n, 0)
            != out["off"]["by_name"].get(n, 0)}
    for rec in out.values():
        del rec["by_name"]
    off = out["off"]
    emit("telemetry_main_path", estimator="dsvb", backend="fused",
         nodes=N_NODES, points_per_node=N_PER_NODE,
         n_iters=TELEMETRY_ITERS, profiled_iters=TELEMETRY_PROFILE_ITERS,
         reps=TELEMETRY_REPS, modes=out,
         host_overhead_share=out["host"]["ms_per_iter"] / off["ms_per_iter"]
         - 1.0,
         taps_overhead_share=out["taps"]["ms_per_iter"] / off["ms_per_iter"]
         - 1.0,
         kernel_call_host_us_added=out["host"]["kernel_call_host_us"]
         - off["kernel_call_host_us"],
         seconds=time.perf_counter() - t_phase)
    misses = []
    for mode, rec in out.items():
        if not torch.equal(phi[mode], phi["off"]):
            misses.append(f"{mode}: phi differs from the run without "
                          "telemetry")
        if rec["iterations_marked"] != TELEMETRY_PROFILE_ITERS \
                or not rec["runtime_launches_in_loop"]:
            misses.append(f"{mode}: the loop was not found in the trace")
        if rec["sync_calls_in_loop"] != off["sync_calls_in_loop"] \
                or rec["d2h_copies_in_loop"] != off["d2h_copies_in_loop"]:
            misses.append(f"{mode}: synchronise calls or device-to-host "
                          f"copies in the loop {rec['sync_calls_in_loop']}, "
                          f"{rec['d2h_copies_in_loop']}")
        if mode != "off" and (rec["kernel_span_count"] != rec["launches"]
                              or not rec["series_kl_bit_equal"]):
            misses.append(f"{mode}: kernel/gmm_estep_nodes spans "
                          f"{rec['kernel_span_count']} for "
                          f"{rec['launches']} launches, vb_run/kl_mean "
                          f"bit-equal {rec['series_kl_bit_equal']}")
    if out["host"]["kernels_in_loop"] != off["kernels_in_loop"]:
        misses.append(f"device kernels in the loop: {off['kernels_in_loop']}"
                      f" off, {out['host']['kernels_in_loop']} host-enabled")
    if misses:
        raise AssertionError("; ".join(misses))
    return out


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


DRIVER_GAUGES = ("driver_queue_depth", "driver_active", "driver_capacity",
                 "driver_occupancy", "driver_padding_waste")
TELEMETRY_DIR = os.path.join(HERE, "build", "chip_smoke_telemetry")
_PROM_LINE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? \S+$")


def _parse_prometheus(text: str) -> dict:
    """{sample with labels: value} of Prometheus text exposition; raises
    on a line that is neither a # TYPE line nor a sample."""
    out = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            if line.split()[3] not in ("counter", "gauge", "histogram"):
                raise ValueError(f"bad TYPE line: {line!r}")
            continue
        if not _PROM_LINE.match(line):
            raise ValueError(f"bad sample line: {line!r}")
        key, value = line.rsplit(" ", 1)
        out[key] = float(value)
    return out


def _fleet_telemetry(reqs, run_off, out_off, dev) -> list:
    """Group C again with telemetry and taps on, against its run with
    them off; then the `vb_serve` launcher in-process with --trace and
    --metrics at a small size.  Returns the misses."""
    from repro_torch.launch import vb_serve

    t0 = time.perf_counter()
    svc, rids, res = run_off
    _telemetry_mode("taps")
    before = ops.gmm_estep_nodes.launches
    svc_on, rids_on, res_on, sub_s, run_s = _fleet_serve(reqs, FLEET_SLICE,
                                                         dev)
    launched = ops.gmm_estep_nodes.launches - before
    st = svc_on.stats()
    iters = st.slices * FLEET_SLICE
    evs = telemetry.tracer().to_chrome()["traceEvents"]
    rows = {r["name"]: r for r in telemetry.snapshot()}
    bit_equal = all(torch.equal(res[a].phi, res_on[b].phi)
                    and res[a].t == res_on[b].t
                    for a, b in zip(rids, rids_on))
    on = {"ms_per_fleet_iter_off": out_off["ms_per_fleet_iter"],
          "ms_per_fleet_iter_on": run_s * 1e3 / iters,
          "slices": st.slices,
          "driver_slice_spans": sum(e["name"] == "driver/slice"
                                    for e in evs),
          "gauges": {g: rows[g]["value"] for g in DRIVER_GAUGES
                     if g in rows},
          "kernel_span_count": sum(e["name"] == "kernel/gmm_estep_nodes"
                                   for e in evs),
          "gmm_estep_launches": launched,
          "span_names": telemetry.tracer().span_names(),
          "vs_off_bit_equal": bit_equal}
    _telemetry_mode("off")
    # the launcher at a small size, its files read back
    os.makedirs(TELEMETRY_DIR, exist_ok=True)
    trace = os.path.join(TELEMETRY_DIR, "vb_serve_trace.json")
    prom = os.path.join(TELEMETRY_DIR, "vb_serve_metrics.prom")
    vb_serve.main(["--sessions", "4", "--budgets", "30,60", "--nodes", "8",
                   "--per-node", "20,13", "--slice", "8", "--max-fleet",
                   "2", "--trace", trace, "--metrics", prom])
    with open(trace) as f:
        n_events = len(json.load(f)["traceEvents"])
    with open(prom) as f:
        samples = _parse_prometheus(f.read())
    _telemetry_mode("off")
    on.update(vb_serve_trace_events=n_events,
              vb_serve_metric_samples=len(samples),
              vb_serve_admitted=samples.get("driver_admitted_total"),
              seconds=time.perf_counter() - t0)
    emit("vb_serve_fleet_telemetry", group="C", **on)
    misses = []
    if not bit_equal:
        misses.append("fleet C with telemetry on: not bit-equal to the run "
                      "with it off")
    if on["driver_slice_spans"] != st.slices \
            or set(on["gauges"]) != set(DRIVER_GAUGES):
        misses.append(f"fleet C telemetry: {on['driver_slice_spans']} "
                      f"slice spans for {st.slices} slices, gauges "
                      f"{sorted(on['gauges'])}")
    if on["kernel_span_count"] != launched:
        misses.append(f"fleet C: kernel/gmm_estep_nodes spans "
                      f"{on['kernel_span_count']} for {launched} launches")
    if not n_events or on["vb_serve_admitted"] != 4.0:
        misses.append(f"vb_serve --trace/--metrics: {n_events} events, "
                      f"{on['vb_serve_admitted']} admitted")
    return misses


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
    misses, solos = [], {}
    for name, reqs in groups.items():
        svc, rids, res = runs[name]
        worst, bit_equal = 0.0, True
        for (r, _), rid in zip(reqs, rids):
            solo = vb_engine.run_vb(
                r.model, r.data, r.topology, n_iters=r.n_iters,
                schedule=r.schedule, init_phi=r.init_phi,
                minibatch=r.minibatch, diagnostics=False, device=dev)
            solos.setdefault(name, []).append(solo.phi)
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

    misses += _fleet_telemetry(groups["C"], runs["C"], out["C"], dev)

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
    svc_c, rids_c, res_c = runs["C"]
    return {"launches": launches["gmm_estep_nodes"], "max_abs_err": err,
            "ms": k_ms, "bound_ms": bound,
            # group C for the mesh phase: requests, fleet and solo results
            "C": (groups["C"], [res_c[r].phi for r in rids_c], solos["C"])}


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
            telemetry.reset()               # the warn-once keys
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
# the sparse main path's host data, made by a worker process while the
# earlier phases run (`start_sparse_data`); it writes x, mask and labels
# to its stdout, then its own seconds
_SPARSE_WORKER = r"""
import os, sys, time
import numpy as np
from repro_torch.data import synthetic
t0 = time.perf_counter()
n, t, seed, chunk = (int(a) for a in sys.argv[1:5])
d = synthetic.paper_synthetic(n_nodes=n, n_per_node=t, seed=seed,
                              dtype=np.float32)
for a in (d.x.numpy(), d.mask.numpy(), d.labels.numpy(),
          np.float64(time.perf_counter() - t0)):
    view = memoryview(np.ascontiguousarray(a)).cast("B")
    while len(view):                 # a write may take part of a chunk
        view = view[os.write(1, view[:chunk]):]
"""
# the worker's pipe is read and written this many bytes a call at most
# (one read or write of 2 GiB or more stops short on Linux)
PIPE_CHUNK = 1 << 26


def start_sparse_data(n: int = SPARSE_N, t: int = N_PER_NODE):
    """The worker process making `paper_synthetic(n, t, seed=SEED)` in
    float32 (no card: CUDA_VISIBLE_DEVICES is empty)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-c", _SPARSE_WORKER, str(n), str(t), str(SEED),
         str(PIPE_CHUNK)], stdout=subprocess.PIPE, bufsize=0, env=env)


def sparse_data(worker, n: int = SPARSE_N, t: int = N_PER_NODE):
    """(the worker's `SensorData`, its seconds): its arrays read from its
    stdout, and the worker waited for; a worker that fails fails here."""
    arrays = (np.empty((n, t, 2), np.float32), np.empty((n, t), np.float32),
              np.empty((n, t), np.int32), np.empty((), np.float64))
    for a in arrays:
        view, got = memoryview(a).cast("B"), 0
        while got < len(view):
            k = worker.stdout.readinto(view[got:got + PIPE_CHUNK])
            if not k:
                worker.wait()
                raise RuntimeError(f"the sparse data worker ended after "
                                   f"{got} of {len(view)} bytes (rc "
                                   f"{worker.returncode})")
            got += k
    if worker.wait() != 0:
        raise RuntimeError(f"the sparse data worker failed: rc "
                           f"{worker.returncode}")
    return synthetic._tensors(*arrays[:3]), float(arrays[3])


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
    with warnings.catch_warnings():     # deprecated torch.distributed
        warnings.simplefilter("ignore", FutureWarning)   # aliases
        objects = gc.get_objects()
        tensors = [o for o in objects if isinstance(o, torch.Tensor)]
    for o in tensors:
        if o.is_cuda:
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


def phase_sparse_main_path(dev, worker) -> dict:
    """Six sparse runs at 100,000 sensors x 4096 points, fused backend,
    SPARSE_ITERS iterations each; then the kernel at that size against
    its plain version, and sparse dSVB against the reference backend.
    The host data comes from `worker` (`start_sparse_data`)."""
    t0 = time.perf_counter()
    g, _pos = network.random_geometric_edges(SPARSE_N, seed=SEED)
    graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    data, data_worker_s = sparse_data(worker)
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
         data_worker_seconds=data_worker_s,
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
    return {"launches": launches["gmm_estep_nodes"], "max_abs_err": err,
            "inst": inst, "graph": gd}


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


def _bound(flops, n_bytes, elem):
    """(bound ms, by): the larger of the bytes over HBM's rate and the
    operations over the peak for their type (bf16 on the tensor cores,
    f32 outside them)."""
    peak = PEAK_BF16_FLOP_PER_S if elem == 2 else PEAK_F32_FLOP_PER_S
    bound = {"bytes": n_bytes / PEAK_BYTES_PER_S * 1e3,
             "operations": flops / peak * 1e3}
    by = max(bound, key=bound.get)
    return bound[by], by


def _flash_bound(B, S, Hq, Hkv, hd, window, elem):
    """(bound ms, by, flops, bytes) of one flash launch: the kernel
    module's count (`flash_attention.op_count`, its FLOP formula too)."""
    flops, n_bytes = flash_attention.op_count(B, S, Hq, Hkv, hd, window,
                                              elem)
    return (*_bound(flops, n_bytes, elem), flops, n_bytes)


def _ssd_bound(B, S, H, P, N, elem):
    """(bound ms, by, flops, bytes) of one ssd_scan launch: the kernel
    module's count (`ssd_scan.op_count`, its FLOP formula too)."""
    flops, n_bytes = ssd_scan.op_count(B, S, H, P, N, elem)
    return (*_bound(flops, n_bytes, elem), flops, n_bytes)


def _sdpa(q, k, v, window=0):
    """torch's scaled_dot_product_attention on the (B, S, H, hd) layout,
    k/v repeated to the query heads first (the library yardstick and the
    second oracle; never on the port's path)."""
    g = q.shape[2] // k.shape[2]
    kr, vr = (torch.repeat_interleave(a, g, dim=2).transpose(1, 2)
              for a in (k, v))
    mask = _window_mask(q.shape[1], window, q.device)
    out = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), kr, vr, attn_mask=mask, is_causal=mask is None)
    return out.transpose(1, 2)


def _window_mask(S: int, window: int, dev):
    """SDPA's boolean mask of a sliding window that cuts keys, or None
    where the window reaches past the sequence (window 0 or >= S: plain
    causal attention, which SDPA takes as `is_causal` on its flash and
    cuDNN backends; an explicit mask would hold it to the slower
    memory-efficient one)."""
    if not window or window >= S:
        return None
    i = torch.arange(S, device=dev)[:, None]
    j = torch.arange(S, device=dev)[None, :]
    return (j <= i) & (j > i - window)


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


def _prefill(cfg, lm, toks, use_kernels):
    """The engine's prefill step on `toks`, with the zero stub embeddings
    the engine feeds a config with a modality frontend."""
    return engine.make_prefill_step(cfg, use_kernels=use_kernels)(
        lm, toks, engine.frontend_stub(cfg, toks.shape[0], toks.device))


def _last_logits(cfg, lm, toks, use_kernels):
    return _prefill(cfg, lm, toks, use_kernels)[0][:, -1].float()


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


def phase_lm_serve(arch: str, dev) -> dict:
    """The port's LM serving path for a published config at full width
    and depth (bf16): Engine.generate with the kernels, launch counts
    around it (one flash launch an attention layer, one ssd launch an SSM
    layer), then its timings and the non-kernel comparison."""
    cfg = get_config(arch)
    t0 = time.perf_counter()
    lm = lm_model.init_params(cfg, torch.Generator(dev).manual_seed(0),
                              device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reqs = _requests(cfg, LM_NEW)
    # warm-up outside the window (library handles, the kernels' load); a
    # frontend config pads its prompts to frontend_len + 1
    warm = max(64, cfg.frontend_len + 1)
    engine.Engine(cfg, lm, max_seq=warm + 2, use_kernels=True,
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
    kinds = cfg.layer_kinds()
    want = {"gmm_estep_nodes": 0, "flash_attention": kinds.count("attn"),
            "ssd_scan": kinds.count("ssm")}
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
        logits, cache = _prefill(cfg, lm, toks, True)
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
        prof_prefill = profile_window(lambda: _prefill(cfg, lm, toks, True),
                                      named=PROFILE_NAMED)
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


def _time_flash(dev, shape=None, window: int = 0) -> dict:
    """flash_attention at a prefill shape (default Yi-6B's): the kernel
    (CUDA events after a warm-up), its plain version and SDPA, beside the
    bound."""
    gen = torch.Generator(dev).manual_seed(2)
    shape = shape or (LM_BATCH, LM_PROMPT, 32, 4, 128)
    B, S, Hq, Hkv, hd = shape
    q, k, v = (torch.randn(B, S, h, hd, generator=gen, device=dev)
               .to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
    ms = time_ms(lambda: ops.flash_attention(q, k, v, window=window), 10)
    plain_ms = time_ms(lambda: flash_attention.flash_attention_plain(
        q, k, v, window=window), 3)
    g = Hq // Hkv
    kr, vr = (torch.repeat_interleave(a, g, dim=2).transpose(1, 2)
              for a in (k, v))
    qt = q.transpose(1, 2)
    mask = _window_mask(S, window, dev)
    library_ms = time_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(
                             qt, kr, vr, attn_mask=mask,
                             is_causal=mask is None), 10)
    bound, by, flops, n_bytes = _flash_bound(*shape, window, 2)
    return {"shape": list(shape), "dtype": "bfloat16", "window": window,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_call": "is_causal" if mask is None else "attn_mask",
            "bound_ms": bound, "bound_by": by, "flops": flops,
            "bytes": n_bytes, "achieved_TFLOPs": flops / ms / 1e9,
            "achieved_GBps": n_bytes / ms / 1e6,
            "library_TFLOPs": flops / library_ms / 1e9,
            "pr12_ms": PR12_FLASH_MS if hd == 128 else None}


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


# ---------------------------------------------------------------------------
# 9. the last LM families and LM training
# ---------------------------------------------------------------------------
# RecurrentGemma-2B's attention layers: MQA, head_dim 256, window 2048
RG_FLASH, RG_WINDOW = (LM_BATCH, LM_PROMPT, 10, 1, 256), 2048
FAMILY_ARCHS = ("recurrentgemma_2b", "granite_moe_3b_a800m", "qwen2_vl_2b")
# training: Batcher batches of 4 x 1024 tokens, 10 steps, warmup 2; ms a
# step is the median of steps 3-10
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_WARMUP = 4, 1024, 10, 2
TRAIN_TIMED_FROM = 2
# Yi-6B at published width, depth cut to 8 of its 32 layers: all 32 are
# 6.06 B params, whose bf16 params and grads (24.2 GB) and f32 AdamW
# moments (48.5 GB) fill the card's 80 GB before any activation; 8 layers
# are 1.91 B params, ~22.9 GB of state
YI_TRAIN_LAYERS = 8
# every arch's f32 smoke config, two allreduce steps on the card against
# the CPU from the same state: tests/test_torch_lm_train.py's bars (loss
# 1e-5 relative, each parameter tensor 1e-4 relative L2 error)
SMALL_STEPS, SMALL_LOSS_RTOL, SMALL_PARAM_RTOL = 2, 1e-5, 1e-4


def phase_lm_flash_hd256(dev, ptxas) -> dict:
    """flash_attention at RecurrentGemma-2B's attention shape (bf16,
    window 2048) against its plain version and SDPA (2e-2), two launches
    bit-identical; its time, the plain version's, SDPA's and the
    operations bound; ptxas's registers and spills for the hd 256
    instance (phase_build asserts none spills)."""
    gen = torch.Generator(dev).manual_seed(4)
    case = _flash_case(*RG_FLASH, torch.bfloat16, RG_WINDOW, dev, gen)[1]
    out = {**case, "time": _time_flash(dev, RG_FLASH, RG_WINDOW),
           "ptxas": [r for r in ptxas if r.get("hd") == 256]}
    emit("lm_flash_hd256", **out)
    return out


class _CollectiveCount:
    """Counts the mesh executor's collectives (calls and bytes handed in)
    while it is entered, by wrapping `dist.collectives`' ppermute, psum
    and all_gather (pmean and the ring exchanges call them)."""

    NAMES = ("ppermute", "psum", "all_gather")

    def __enter__(self):
        self.calls = dict.fromkeys(self.NAMES, 0)
        self.bytes = dict.fromkeys(self.NAMES, 0)
        self.saved = {n: getattr(collectives, n) for n in self.NAMES}
        for n in self.NAMES:
            def counted(x, *a, _n=n, **k):
                self.calls[_n] += 1
                self.bytes[_n] += x.numel() * x.element_size()
                return self.saved[_n](x, *a, **k)
            setattr(collectives, n, counted)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(collectives, n, fn)


def _train_run(trainer, n_steps: int) -> dict:
    """`n_steps` steps through `Trainer.run`, each step's metrics read to
    the host: ms a step by the loop's host clock (Batcher's host sampling
    included), the loss and grad norm each step, peak memory, the kernel
    launches in the window (training runs the plain forward: none), and
    the collectives a step."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()                               # the path's window
    with _CollectiveCount() as cc:
        hist = trainer.run(n_steps, log_every=1)
    torch.cuda.synchronize()
    launches = read_launches()                    # read just after
    walls = [0.0] + [h["wall_s"] for h in hist]
    step_ms = [1e3 * (b - a) for a, b in zip(walls, walls[1:])]
    losses = [h["loss"] for h in hist]
    if not all(np.isfinite(losses)) or any(launches.values()):
        raise AssertionError(f"training: losses {losses}, kernel launches "
                             f"{launches} (want finite, none)")
    t0 = time.perf_counter()
    trainer.batcher.next_batch()
    data_ms = (time.perf_counter() - t0) * 1e3
    med = float(np.median(step_ms[TRAIN_TIMED_FROM:]))
    return {"steps": n_steps, "step_ms": step_ms,
            "ms_per_step_median_3_10": med,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med * 1e3,
            "batcher_ms_per_batch": data_ms,
            "loss": losses, "grad_norm": [h["grad_norm"] for h in hist],
            "lr": [h["lr"] for h in hist],
            "consensus_residual": [h.get("consensus_residual")
                                   for h in hist],
            "admm_rho": [h.get("admm_rho") for h in hist],
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "kernel_launches": launches,
            "collectives_per_step": {n: c / n_steps
                                     for n, c in cc.calls.items()},
            "collective_bytes_per_step": {n: b / n_steps
                                          for n, b in cc.bytes.items()}}


def _trainer(cfg, dev, dp_mode="allreduce", mesh=None, seed=0):
    hyper = train_step.TrainHyper(peak_lr=3e-4, warmup=TRAIN_WARMUP,
                                  total_steps=TRAIN_STEPS)
    return Trainer(cfg, mesh, dp_mode=dp_mode, hyper=hyper,
                   global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=seed,
                   device=dev)


def phase_lm_train_yi_6b(dev) -> dict:
    """`Trainer` in allreduce mode on Yi-6B at published width (d 4096,
    32/4 heads, d_ff 11008, V 64,000, bf16 params, remat as the config
    has it), depth cut to YI_TRAIN_LAYERS."""
    cfg = get_config("yi_6b").replace(n_layers=YI_TRAIN_LAYERS)
    t0 = time.perf_counter()
    tr = _trainer(cfg, dev)
    torch.cuda.synchronize()
    out = {"arch": "yi_6b", "layers": cfg.n_layers,
           "layers_published": get_config("yi_6b").n_layers,
           "cut": "depth 8 of 32 layers: the AdamW state of all 32 does "
                  "not fit 80 GB", "params": lm_model.param_count(cfg),
           "dtype": cfg.param_dtype, "remat": cfg.remat,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "init_s": time.perf_counter() - t0,
           **_train_run(tr, TRAIN_STEPS)}
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    emit("lm_train_yi_6b", **out)
    return out


def phase_lm_train_mamba2_370m(dev, mesh) -> dict:
    """The whole published Mamba-2 370M (48 layers, bf16) trained in the
    three modes; the consensus modes over `mesh`, a one-rank ("data",)
    mesh (one plain replica)."""
    cfg = get_config("mamba2_370m")
    out = {"arch": "mamba2_370m", "layers": cfg.n_layers,
           "params": lm_model.param_count(cfg), "dtype": cfg.param_dtype,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ}
    for mode in train_step.DP_MODES:
        tr = _trainer(cfg, dev, mode, None if mode == "allreduce" else mesh)
        out[mode] = _train_run(tr, TRAIN_STEPS)
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    emit("lm_train_mamba2_370m", **out)
    return out


def phase_lm_train_small_vs_cpu(dev) -> dict:
    """Every ARCH_ID's f32 smoke config: SMALL_STEPS allreduce steps on
    the card against the same steps on the CPU from the same state (the
    MoE scatter, the RG-LRU scan, remat and the frontends on the
    device)."""
    out = {}
    hyper = train_step.TrainHyper(peak_lr=1e-3, warmup=1, total_steps=10)
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch)
        cpu = train_step.init_state(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
        card = train_step.train_state_to(cpu, dev)
        batcher = tokens.Batcher(cfg.vocab_size, 4, 32, seed=0,
                                 frontend_len=cfg.frontend_len,
                                 d_model=cfg.d_model)
        step = train_step.make_train_step(cfg, hyper=hyper)
        loss_err = 0.0
        for _ in range(SMALL_STEPS):
            b = batcher.next_batch()
            cpu, m_cpu = step(cpu, train_step.batch_to(b, "cpu"))
            card, m_card = step(card, train_step.batch_to(b, dev))
            loss_err = max(loss_err, abs(float(m_card["loss"])
                                         - float(m_cpu["loss"]))
                           / abs(float(m_cpu["loss"])))
        want = dict(cpu.params.named_parameters())
        param_err = max(float((p.detach().cpu() - want[n].detach()).norm()
                              / want[n].detach().norm().clamp_min(1e-30))
                        for n, p in card.params.named_parameters())
        out[arch] = {"loss_rel_err": loss_err, "param_rel_l2_err": param_err}
        if loss_err > SMALL_LOSS_RTOL or param_err > SMALL_PARAM_RTOL:
            raise AssertionError(f"{arch}: card vs CPU {out[arch]}")
    emit("lm_train_small_vs_cpu", steps=SMALL_STEPS, dtype="float32",
         loss_rtol=SMALL_LOSS_RTOL, param_rel_l2=SMALL_PARAM_RTOL, **out)
    return out


# ---------------------------------------------------------------------------
# 10. LM sharding on a (1, 1) device mesh
# ---------------------------------------------------------------------------
MESH_TRAIN_STEPS = 3


def _engine_steps(eng, toks) -> dict:
    """One prefill of `toks` and LM_NEW decode steps on its cache through
    `eng`'s own step functions and layout (host clock, synchronised; each
    decode step ends in the host read of its token): prefill ms, ms a
    decode step, the prefill's last-position logits (whole), and the
    kernel launches and peak device memory (above what was allocated
    before it) of the prefill alone."""
    cfg, B = eng.cfg, toks.shape[0]
    end = LM_PROMPT + LM_NEW
    with eng.context():
        rows = eng._rows(toks)
        frontend = eng._rows(engine.frontend_stub(cfg, B, toks.device))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        zero_launches()
        t0 = time.perf_counter()
        logits, cache = eng._prefill(eng.params, rows, frontend)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        launches = read_launches()
        prefill_peak = torch.cuda.max_memory_allocated() - before
        # a copy: a view would hold the whole (B, S, V) logits alive
        last = sharding.full(logits)[:, -1].float().clone()
        full = eng._decode_cache(B, end)
        cache = engine._splice_cache(cfg, full, cache, LM_PROMPT)
        cur = engine._sample(logits, 0.0, None)
        del logits
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(LM_PROMPT, end):
            out, cache = eng._decode(eng.params, cur, cache, t)
            cache = eng._at_rest(cache, full)
            cur = engine._sample(out, 0.0, None)
            sharding.full(cur).cpu()
        decode_ms = (time.perf_counter() - t0) * 1e3 / LM_NEW
        del cache, full
    return {"prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
            "launches_per_prefill": launches,
            "prefill_peak_bytes": prefill_peak, "last_logits": last}


def _counted_prefill(eng, toks) -> dict:
    """The mesh engine's prefill of `toks` once more, under the dry
    run's counting mode (`hlo_analysis.count`): its FLOPs, the kernels'
    op calls, the parameters' local bytes."""
    with eng.context():
        c = hlo_analysis.count(
            lambda params, tokens: eng._prefill(params, tokens, None),
            {"params": eng.params, "tokens": eng._rows(toks)})
        torch.cuda.synchronize()
    return {"flops": c.flops, "kernel_calls": c.kernel_calls,
            "param_bytes": hlo_analysis.local_bytes(eng.params),
            "temp_bytes": c.temp_bytes}


def phase_lm_mesh_serve(arch: str, dev, mesh, count_prefill=False) -> dict:
    """`Engine(mesh=)` on a published config at full width and depth
    (bf16, the kernels) against the unsharded `Engine` on the same
    parameters: the greedy tokens equal, the last prefill logits
    bit-equal, one kernel launch a layer in each prefill (on the rank's
    local shards under the mesh), and each engine's generate window
    (launches, s, peak memory), prefill ms and ms a decode step.  With
    `count_prefill`, the mesh engine's prefill counted as the dry run
    counts (`_counted_prefill`, for `launch_dryrun`)."""
    cfg = get_config(arch)
    lm = lm_model.init_params(cfg, torch.Generator(dev).manual_seed(0),
                              device=dev)
    reqs = _requests(cfg, LM_NEW)
    toks = torch.as_tensor(admission.right_aligned_batch(
        [r.prompt for r in reqs]), dtype=torch.int64, device=dev)
    kinds = cfg.layer_kinds()
    want = {"gmm_estep_nodes": 0, "flash_attention": kinds.count("attn"),
            "ssd_scan": kinds.count("ssm")}
    out = {"arch": arch, "layers": cfg.n_layers, "dtype": cfg.param_dtype,
           "mesh_axes": mesh_lib.axis_sizes(mesh), "batch": LM_BATCH,
           "prompt": LM_PROMPT, "new_tokens": LM_NEW}
    toks_out, logits = {}, {}
    for name, m in (("plain", None), ("mesh", mesh)):
        eng = engine.Engine(cfg, lm, max_seq=LM_PROMPT + LM_NEW,
                            use_kernels=True, device=dev, mesh=m)
        # warm-up outside the window (DTensor's sharding propagation
        # caches, the library handles)
        eng.generate([engine.Request(r.prompt[:64], 2) for r in reqs])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()                           # the path's window
        t0 = time.perf_counter()
        toks_out[name] = eng.generate(reqs)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches = read_launches()                # read just after
        peak = torch.cuda.max_memory_allocated()
        steps = _engine_steps(eng, toks)
        logits[name] = steps.pop("last_logits")
        if launches != want or steps["launches_per_prefill"] != want:
            raise AssertionError(f"{arch} {name}: launches {launches}, a "
                                 f"prefill {steps['launches_per_prefill']}"
                                 f" (want {want} each)")
        out[name] = {"launches": launches, "generate_s": gen_s,
                     "generate_tokens_per_s": LM_BATCH * LM_NEW / gen_s,
                     "max_memory_allocated_gb": peak / 1e9, **steps}
        if count_prefill and m is not None:
            out[name]["counted"] = _counted_prefill(eng, toks)
        del eng
        torch.cuda.empty_cache()
    out["tokens_equal"] = all(np.array_equal(a, b) for a, b in
                              zip(toks_out["plain"], toks_out["mesh"]))
    out["last_logits_bit_equal"] = bool(torch.equal(logits["plain"],
                                                    logits["mesh"]))
    out["decode_ms_ratio_mesh_to_plain"] = (
        out["mesh"]["decode_ms_per_step"]
        / out["plain"]["decode_ms_per_step"])
    out["prefill_ms_ratio_mesh_to_plain"] = (
        out["mesh"]["prefill_ms"] / out["plain"]["prefill_ms"])
    if not (out["tokens_equal"] and out["last_logits_bit_equal"]):
        raise AssertionError(f"{arch}: the mesh engine differs from the "
                             f"unsharded one: tokens equal "
                             f"{out['tokens_equal']}, logits bit-equal "
                             f"{out['last_logits_bit_equal']}")
    del lm, logits
    gc.collect()
    torch.cuda.empty_cache()
    emit(f"lm_mesh_serve_{arch}", **out)
    return out


def _train_states_equal(a, b) -> bool:
    """Two training states bit for bit, in the checkpoint layout (DTensors
    gathered whole)."""
    fa = ckpt._flatten(train_step.train_state_tree(a))
    fb = ckpt._flatten(train_step.train_state_tree(b))
    if sorted(fa) != sorted(fb):
        return False
    return all(torch.equal(fa[k], fb[k]) if isinstance(fa[k], torch.Tensor)
               else fa[k] == fb[k] for k in fa)


def phase_lm_mesh_train(dev, mesh, data) -> dict:
    """Mamba-2 370M (published, bf16), `Trainer(mesh=)` in allreduce and
    ADMM on the (1, 1) `mesh`, MESH_TRAIN_STEPS steps on the Batcher's
    batches, against the unsharded Trainer (allreduce: no mesh; ADMM: the
    one-rank ("data",) mesh `data`, a plain replica): the states bit for
    bit and ms a step of both.  Then a mesh trainer's checkpoint restored
    into a fresh mesh trainer bit for bit, in both modes, on Mamba-2's
    bf16 smoke config: the 48-layer state's compressed file takes
    minutes a round trip."""
    cfg = get_config("mamba2_370m")
    out = {"arch": "mamba2_370m", "layers": cfg.n_layers,
           "dtype": cfg.param_dtype, "mesh_axes": mesh_lib.axis_sizes(mesh),
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": MESH_TRAIN_STEPS}
    for mode in ("allreduce", "admm"):
        runs, states = {}, {}
        for name, m in (("plain", None if mode == "allreduce" else data),
                        ("mesh", mesh)):
            tr = _trainer(cfg, dev, mode, m)
            torch.cuda.synchronize()
            hist = tr.run(MESH_TRAIN_STEPS, log_every=1)
            torch.cuda.synchronize()
            walls = [0.0] + [h["wall_s"] for h in hist]
            runs[name] = {"step_ms": [1e3 * (b - a) for a, b in
                                      zip(walls, walls[1:])],
                          "loss": [h["loss"] for h in hist]}
            states[name] = tr.state
            del tr
        same = _train_states_equal(states["plain"], states["mesh"])
        del states
        gc.collect()
        torch.cuda.empty_cache()
        out[mode] = {**runs, "state_bit_equal": same,
                     "losses_equal": runs["plain"]["loss"]
                     == runs["mesh"]["loss"]}
        if not (same and out[mode]["losses_equal"]):
            raise AssertionError(f"lm_mesh_train {mode}: {out[mode]}")
    small = get_smoke_config("mamba2_370m").replace(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    root = os.path.join("build", "chip_smoke_ckpt", "lm_mesh_train")
    for mode in ("allreduce", "admm"):
        kw = dict(dp_mode=mode, hyper=train_step.TrainHyper(
            peak_lr=1e-3, warmup=1, total_steps=10), global_batch=4,
            seq_len=64, device=dev, ckpt_dir=os.path.join(root, mode))
        tr = Trainer(small, mesh, **kw)
        tr.run(2, log_every=100)
        tr.save(2)
        back = Trainer(small, mesh, seed=1, **kw)
        back.restore(2)
        out[mode]["save_restore_bit_equal"] = _train_states_equal(
            tr.state, back.state)
        if not out[mode]["save_restore_bit_equal"]:
            raise AssertionError(f"lm_mesh_train {mode}: the checkpoint "
                                 f"does not round-trip")
    out["save_restore_config"] = "mamba2_370m smoke, bf16"
    emit("lm_mesh_train", **out)
    return out


# ---------------------------------------------------------------------------
# 6n. the mesh executor under a one-rank NCCL group (admission.data_axis_mesh)
# ---------------------------------------------------------------------------
MESH_ITERS, MESH_REPS, MESH_PROFILE_ITERS = 20, 7, 10
MESH_CASES = ("dsvb", "ring_link_drop", "admm_adaptive_per_block", "cvb")
MESH_FLEET_REPS, MESH_SPARSE_ITERS = 3, 5
# row slices of the main shape: a two-rank split and an interior block
MESH_ROW_SLICES = ((0, 500), (500, 1000), (250, 750))


def _mesh_run(name, inst, executor, dev, n_iters=None):
    """A main-path case through run_vb, on `executor` (None: the
    single-array executor): fused backend, f32 data, f64 iterates,
    MESH_ITERS iterations unless told."""
    cfg, x, mask, adj, W, prior, ref, init_q = inst
    mdl = GMMModel(prior, cfg.K, cfg.D, backend="fused", device=dev)
    phi0 = expfam.pack_natural(init_q).expand(x.shape[0], mdl.flat_dim)
    sched = vb_engine.Schedule(tau=cfg.tau, d0=cfg.d0)
    topo = {"dsvb": vb_engine.Diffusion(W),
            "ring_link_drop": vb_engine.RingDiffusion(link_drop=0.2,
                                                      link_seed=SEED),
            "admm_adaptive_per_block": vb_engine.ADMMConsensus(
                adj, rho=cfg.rho, xi=cfg.xi, adaptive_rho=True,
                per_block=True),
            "cvb": vb_engine.FusionCenter()}[name]
    if name == "admm_adaptive_per_block":
        sched = vb_engine.Schedule()
    elif name == "cvb":
        sched = vb_engine.ONE_SHOT
    return vb_engine.run_vb(mdl, (x, mask), topo,
                            n_iters=n_iters or MESH_ITERS, schedule=sched,
                            init_phi=phi0, ref_phi=ref, executor=executor,
                            device=dev)


def _runs_bit_equal(a, b) -> bool:
    same = (torch.equal(a.phi, b.phi) and torch.equal(a.kl_nodes, b.kl_nodes)
            and torch.equal(a.consensus_err, b.consensus_err))
    if a.consensus_diag is not None:
        same = same and all(torch.equal(u, v) for u, v in zip(
            a.consensus_diag, b.consensus_diag))
    return same


def _median_range(v) -> dict:
    return {"median": float(np.median(v)), "min": float(min(v)),
            "max": float(max(v))}


def phase_mesh_main_path(inst, ex, dev) -> dict:
    """The main path's cases under the executor against the single-array
    executor (module docstring, 6n)."""
    t_phase = time.perf_counter()
    for name in MESH_CASES:                         # warm-up, outside
        _mesh_run(name, inst, ex, dev, 2)
        _mesh_run(name, inst, None, dev, 2)
    torch.cuda.synchronize()
    zero_launches()                                 # this path's window
    mesh = {name: _mesh_run(name, inst, ex, dev) for name in MESH_CASES}
    torch.cuda.synchronize()
    launches = read_launches()                      # read just after
    out, misses = {}, []
    for name in MESH_CASES:
        single = _mesh_run(name, inst, None, dev)
        out[name] = {"bit_equal": _runs_bit_equal(mesh[name], single),
                     "kl_last": float(mesh[name].kl_mean[-1])}
        if not out[name]["bit_equal"]:
            misses.append(f"{name}: the executor's run is not bit-equal")
    if launches["gmm_estep_nodes"] != len(MESH_CASES) * MESH_ITERS:
        misses.append(f"gmm_estep launches {launches}")
    # ms an iteration, the executor and the single array in turns
    for name in MESH_CASES:
        ms = {"mesh": [], "single": []}
        for _ in range(MESH_REPS):
            for mode, executor in (("single", None), ("mesh", ex)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _mesh_run(name, inst, executor, dev)
                torch.cuda.synchronize()
                ms[mode].append((time.perf_counter() - t0) * 1e3
                                / MESH_ITERS)
        out[name].update(ms_per_iter={m: _median_range(v)
                                      for m, v in ms.items()})
    # device events an iteration (profiled): the executor's against the
    # single array's, by name; NCCL's kernels, and c10d's `nccl:*`
    # ranges (the profiler mirrors them on the device's timeline)
    for name in MESH_CASES:
        prof = {mode: profile_window(lambda: _mesh_run(
            name, inst, executor, dev, MESH_PROFILE_ITERS), counts=True)
            for mode, executor in (("mesh", ex), ("single", None))}
        c_mesh, c_single = prof["mesh"]["counts"], prof["single"]["counts"]
        added = {k: (c_mesh.get(k, 0) - c_single.get(k, 0))
                 / MESH_PROFILE_ITERS for k in set(c_mesh) | set(c_single)}
        added = dict(sorted(((k[:60], v) for k, v in added.items() if v),
                            key=lambda kv: -abs(kv[1]))[:10])
        for mode, p in prof.items():
            c = p["counts"]
            out[name][f"profile_{mode}"] = {
                "device_events_per_iter": p["kernels_launched"]
                / MESH_PROFILE_ITERS,
                "nccl_kernels_per_iter": sum(
                    v for k, v in c.items() if k.startswith("nccl")
                    and not k.startswith("nccl:")) / MESH_PROFILE_ITERS,
                "c10d_nccl_ranges_per_iter": sum(
                    v for k, v in c.items() if k.startswith("nccl:"))
                / MESH_PROFILE_ITERS,
                "device_busy_ms_per_iter": p["device_busy_ms"]
                / MESH_PROFILE_ITERS,
                "device_idle_share": p["device_idle_share"]}
        out[name]["events_added_per_iter"] = added
        emit("mesh_main_path", case=name, nodes=N_NODES,
             points_per_node=N_PER_NODE, n_iters=MESH_ITERS, ranks=1,
             backend=str(dist.get_backend()), **out[name])
    # a launch over a row slice against the same rows of the whole
    # launch, bit for bit: each rank launches the kernel on its rows
    cfg, x, mask = inst[:3]
    q = expfam.unpack_natural(mesh["dsvb"].phi, cfg.K, cfg.D)
    shift = q.m.float().contiguous()
    terms = [t.contiguous() for t in gmm.estep_terms(q, torch.float32,
                                                     shift=shift)]
    whole = ops.gmm_estep_nodes(x, mask, *terms, float(N_NODES),
                                shift=shift, return_r=True)
    slices = []
    for lo, hi in MESH_ROW_SLICES:
        part = ops.gmm_estep_nodes(
            x[lo:hi].contiguous(), mask[lo:hi].contiguous(),
            *(t[lo:hi].contiguous() for t in terms), float(N_NODES),
            shift=shift[lo:hi].contiguous(), return_r=True)
        same = all(torch.equal(p, w[lo:hi]) for p, w in zip(part, whole))
        slices.append({"rows": [lo, hi], "bit_equal": same})
        if not same:
            misses.append(f"gmm_estep rows {lo}:{hi} differ from the "
                          "whole launch")
    emit("mesh_main_path_summary", cases=list(MESH_CASES), launches=launches,
         gmm_estep_launches_per_iter=launches["gmm_estep_nodes"]
         / (len(MESH_CASES) * MESH_ITERS),
         kernel_variant=gmm_estep.kernel_variant(cfg.K, cfg.D),
         row_slices=slices, seconds=time.perf_counter() - t_phase)
    if misses:
        raise AssertionError("; ".join(misses))
    return {"launches": launches["gmm_estep_nodes"]}


def phase_mesh_serve_fleet(fleet_c, ex, dev) -> dict:
    """Serving group C (4 rings with link drops, 1000 x 4096 each, 100
    iterations, 25-iteration slices) under the executor: each tenant
    bit-equal to the single-array fleet's result and to its solo run; ms
    per fleet iteration against the single-array fleet's, in turns."""
    t_phase = time.perf_counter()
    reqs, fleet_phi, solo_phi = fleet_c

    def serve(executor):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc = vb_service.VBService(slice_iters=FLEET_SLICE,
                                   max_fleet=FLEET_MAX, bucket="pow2",
                                   executor=executor, device=dev)
        rids = [svc.submit(r, arrive_at=a) for r, a in reqs]
        res = svc.run()
        torch.cuda.synchronize()
        st = svc.stats()
        return ([res[r].phi for r in rids], st,
                (time.perf_counter() - t0) * 1e3
                / (st.slices * FLEET_SLICE))

    serve(ex)                                       # warm-up, outside
    zero_launches()                                 # this path's window
    got, st, _ = serve(ex)
    launches = read_launches()                      # read just after
    iters = st.slices * FLEET_SLICE
    ms = {"mesh": [], "single": []}
    for _ in range(MESH_FLEET_REPS):
        for mode, executor in (("single", None), ("mesh", ex)):
            ms[mode].append(serve(executor)[2])
    vs_fleet = all(torch.equal(a, b) for a, b in zip(got, fleet_phi))
    vs_solo = all(torch.equal(a, b) for a, b in zip(got, solo_phi))
    emit("mesh_serve_fleet", group="C", tenants=len(reqs), nodes=N_NODES,
         points_per_node=N_PER_NODE, slice_iters=FLEET_SLICE, ranks=1,
         fleet_iterations=iters, compiles=st.compiles,
         gmm_estep_launches=launches["gmm_estep_nodes"],
         gmm_estep_launches_per_fleet_iter=launches["gmm_estep_nodes"]
         / iters, bit_equal_single_array_fleet=vs_fleet,
         bit_equal_solo=vs_solo,
         ms_per_fleet_iter={m: _median_range(v) for m, v in ms.items()},
         seconds=time.perf_counter() - t_phase)
    if not (vs_fleet and vs_solo) or launches["gmm_estep_nodes"] != iters \
            or st.compiles != 1:
        raise AssertionError(f"mesh fleet: vs fleet {vs_fleet}, vs solo "
                             f"{vs_solo}, {launches}, {st}")
    return {"launches": launches["gmm_estep_nodes"]}


def phase_mesh_sparse(inst, gd, ex, dev) -> dict:
    """Sparse dSVB at 100,000 x 4096 under the executor against the
    single-array executor: bit-equal, ms an iteration, peak memory."""
    cfg, x, mask, prior, ref, init_q = inst
    sw = network.sparse_nearest_neighbor_weights(gd)

    def run(executor, n_iters):
        mdl = GMMModel(prior, cfg.K, cfg.D, backend="fused", device=dev)
        phi0 = expfam.pack_natural(init_q).expand(x.shape[0], mdl.flat_dim)
        return vb_engine.run_vb(
            mdl, (x, mask), vb_engine.Diffusion(sw), n_iters=n_iters,
            schedule=vb_engine.Schedule(tau=cfg.tau, d0=cfg.d0),
            init_phi=phi0, ref_phi=ref, executor=executor, device=dev)

    run(ex, 1)                                      # warm-up, outside
    out = {}
    for mode, executor in (("single", None), ("mesh", ex)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if mode == "mesh":
            zero_launches()                         # this path's window
        t0 = time.perf_counter()
        r = run(executor, MESH_SPARSE_ITERS)
        torch.cuda.synchronize()
        out[mode] = {"run": r, "ms_per_iter": (time.perf_counter() - t0)
                     * 1e3 / MESH_SPARSE_ITERS,
                     "peak_bytes": torch.cuda.max_memory_allocated()}
    launches = read_launches()                      # read just after
    same = _runs_bit_equal(out["mesh"]["run"], out["single"]["run"])
    emit("mesh_sparse", nodes=SPARSE_N, points_per_node=N_PER_NODE,
         n_iters=MESH_SPARSE_ITERS, ranks=1, bit_equal=same,
         launches=launches,
         **{f"{m}_{k}": o[k] for m, o in out.items()
            for k in ("ms_per_iter", "peak_bytes")},
         kl_last=float(out["mesh"]["run"].kl_mean[-1]))
    if not same or launches["gmm_estep_nodes"] != MESH_SPARSE_ITERS:
        raise AssertionError(f"mesh sparse: bit-equal {same}, {launches}")
    return {"launches": launches["gmm_estep_nodes"]}


# ---------------------------------------------------------------------------
# 11. the allocation-free dry run of the production meshes (launch.dryrun)
# ---------------------------------------------------------------------------
# (arch, shape, multi_pod, dp_mode, use_kernels) at published width
DRYRUN_CASES = (("yi_6b", "train_4k", False, "allreduce", False),
                ("yi_6b", "train_4k", False, "admm", False),
                ("yi_6b", "prefill_32k", False, "allreduce", True),
                ("mamba2_370m", "prefill_32k", False, "allreduce", True),
                ("grok_1_314b", "train_4k", True, "allreduce", False))
# the dry run's worker: a process of its own, since its fake world of 256
# or 512 ranks is a default process group (as the reference's dry run
# sets its device count in a process of its own).  It prints one JSON
# line a production case, then Yi-6B's prefill at lm_mesh_serve's shape
# on a fake (1, 1) world with the kernels, then its seconds and the
# card's memory it allocated (none: the tensors are on meta)
_DRYRUN_WORKER = r"""
import json, sys, time
import torch
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.launch import dryrun, hlo_analysis, specs
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.model import param_count
t0 = time.perf_counter()
torch.set_num_threads(1)
cases, (batch, prompt) = json.loads(sys.argv[1]), json.loads(sys.argv[2])
for arch, shape, multi_pod, dp_mode, kern in cases:
    with dryrun.fake_world(512 if multi_pod else 256):
        rep = dryrun.run_one(arch, shape, multi_pod=multi_pod,
                             dp_mode=dp_mode, use_kernels=kern,
                             verbose=False)
    print(json.dumps({"case": rep}), flush=True)
with dryrun.fake_world(1):
    mesh = make_test_mesh(1, 1, device=dryrun.mesh_device())
    cfg = get_config("yi_6b")
    fn, inputs = specs.build_step(
        cfg, ShapeConfig("lm_mesh_serve", prompt, batch, "prefill"), mesh,
        use_kernels=True)
    c = hlo_analysis.count(fn, inputs)
    mf = 2.0 * param_count(cfg, active_only=True) * batch * prompt
    print(json.dumps({"mesh11": {
        **hlo_analysis.roofline(c, 1, mf).as_dict(),
        "kernel_calls": c.kernel_calls, "temp_bytes": c.temp_bytes,
        "param_bytes": hlo_analysis.local_bytes(inputs["params"]),
        "mesh_device": mesh.device_type, "count_s": c.seconds}}),
        flush=True)
print(json.dumps({"done": {
    "seconds": time.perf_counter() - t0,
    "cuda_allocated": (torch.cuda.memory_allocated()
                       if torch.cuda.is_available() else 0)}}), flush=True)
"""
# the (1, 1) dry run's FLOPs against the model's 2 N_active tokens: the
# matmuls plus the attention (~4% at 2048 tokens) and no embedding
# lookup; outside this range the counting mode missed ops or counted an
# op twice on both sides (which the equality alone cannot show)
DRYRUN_FLOPS_VS_MODEL = (0.9, 1.3)
DRYRUN_TIMEOUT_S = 300


def start_dryrun():
    """The dry run's worker (`_DRYRUN_WORKER`), started early so that
    its host time overlaps the card's phases; its stdout is read by
    `phase_launch_dryrun`."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               OMP_NUM_THREADS="1")
    cases = json.dumps([list(c) for c in DRYRUN_CASES])
    return subprocess.Popen(
        [sys.executable, "-c", _DRYRUN_WORKER, cases,
         json.dumps([LM_BATCH, LM_PROMPT])], stdout=subprocess.PIPE,
        text=True, env=env)


def phase_launch_dryrun(worker, real: dict) -> None:
    """The production cases' per-card rooflines (H100 peaks), and Yi-6B's
    prefill at lm_mesh_serve's shape dry-run on a (1, 1) mesh against the
    real `Engine(mesh=mesh11)` run (`real`, phase_lm_mesh_serve's "mesh"
    entry): parameter bytes equal, FLOPs equal to the same counting mode
    over the real prefill, the kernels' op counts equal to its launches;
    the measured prefill ms against max(Tc, Tm) and the predicted temp
    bytes against the prefill's peak memory (written down, not gated).
    A dry run that raises fails the worker, and this phase."""
    try:
        out, _ = worker.communicate(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        worker.kill()
        worker.wait()
        raise
    if worker.returncode != 0:
        raise RuntimeError(f"the dry-run worker failed: rc "
                           f"{worker.returncode}")
    lines = [json.loads(line) for line in out.splitlines()
             if line.startswith("{")]
    cases = [d["case"] for d in lines if "case" in d]
    m11 = next(d["mesh11"] for d in lines if "mesh11" in d)
    done = next(d["done"] for d in lines if "done" in d)
    for rep in cases:
        mem = rep["memory_analysis"]
        emit("launch_dryrun_case", **{k: rep[k] for k in (
            "arch", "shape", "mesh", "mesh_device", "dp_mode",
            "use_kernels", "t_compute_s", "t_memory_s", "t_collective_s",
            "bottleneck", "useful_flops_ratio", "coll_counts",
            "kernel_calls", "compile_s")},
            argument_gib=mem["argument_size_in_bytes"] / 2**30,
            temp_gib=mem["temp_size_in_bytes"] / 2**30)
    counted = real["counted"]
    want_calls = {k: v for k, v in real["launches_per_prefill"].items()
                  if v}
    roof_ms = max(m11["t_compute_s"], m11["t_memory_s"]) * 1e3
    ratio = m11["flops"] / m11["model_flops"]
    checks = {
        "param_bytes_equal": m11["param_bytes"] == counted["param_bytes"],
        "flops_equal": m11["flops"] == counted["flops"],
        "kernel_calls_equal_launches": (m11["kernel_calls"] == want_calls
                                        == counted["kernel_calls"]),
        "flops_vs_model_in_range": (DRYRUN_FLOPS_VS_MODEL[0] <= ratio
                                    <= DRYRUN_FLOPS_VS_MODEL[1]),
        "five_cases": len(cases) == len(DRYRUN_CASES),
        "no_card_memory": done["cuda_allocated"] == 0}
    emit("launch_dryrun", **checks, mesh_device=m11["mesh_device"],
         dry_flops=m11["flops"], real_counted_flops=counted["flops"],
         flops_over_model=ratio, dry_param_bytes=m11["param_bytes"],
         real_param_bytes=counted["param_bytes"],
         dry_kernel_calls=m11["kernel_calls"], real_launches=want_calls,
         t_compute_ms=m11["t_compute_s"] * 1e3,
         t_memory_ms=m11["t_memory_s"] * 1e3,
         roofline_ms=roof_ms, measured_prefill_ms=real["prefill_ms"],
         roofline_share=roof_ms / real["prefill_ms"],
         predicted_temp_bytes=m11["temp_bytes"],
         real_counted_temp_bytes=counted["temp_bytes"],
         prefill_peak_bytes=real["prefill_peak_bytes"],
         worker_seconds=done["seconds"], count_s=m11["count_s"])
    if not all(checks.values()):
        raise AssertionError(f"launch_dryrun: {checks}")


def main():
    dev_info = phase_device()
    worker = start_sparse_data()
    dry = start_dryrun()
    try:
        run(dev_info, worker, dry)
    finally:
        for w in (worker, dry):
            if w.poll() is None:            # a phase before it failed
                w.kill()
                w.wait()


def run(dev_info, worker, dry):
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
    phase_telemetry_main_path(inst, dev)
    phase_engine_remainder(inst, dev)
    # a one-rank NCCL group; a failed initialisation fails the run
    ex = admission.data_axis_mesh(device=dev)
    mesh = phase_mesh_main_path(inst, ex, dev)["launches"]
    phase_stream_main_path(inst, dev)
    fleet = phase_vb_serve_fleet(inst, dev)
    mesh += phase_mesh_serve_fleet(fleet.pop("C"), ex, dev)["launches"]
    del inst, x, mask
    torch.cuda.empty_cache()
    sparse = phase_sparse_main_path(dev, worker)
    mesh += phase_mesh_sparse(sparse.pop("inst"), sparse.pop("graph"), ex,
                              dev)["launches"]
    dist.destroy_process_group()
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
    yi = phase_lm_serve("yi_6b", dev)
    yi["flash_attention"] = fa = _time_flash(dev)
    yi["flash_share_of_prefill"] = yi["layers"] * fa["ms"] / yi["prefill_ms"]
    emit("lm_serve_yi_6b", **yi)
    mb = phase_lm_serve("mamba2_370m", dev)
    mb["ssd_scan"] = sd = _time_ssd(dev)
    mb["ssd_share_of_prefill"] = mb["layers"] * sd["ms"] / mb["prefill_ms"]
    emit("lm_serve_mamba2_370m", **mb)
    hd256 = phase_lm_flash_hd256(dev, ptxas["flash_attention"])
    flash_launches = yi["launches"]["flash_attention"]
    for arch in FAMILY_ARCHS:
        fam = phase_lm_serve(arch, dev)
        emit(f"lm_serve_{arch}", **fam)
        flash_launches += fam["launches"]["flash_attention"]
    # a one-rank NCCL group and the (1, 1) mesh over it; a failed
    # initialisation fails the run
    mesh11 = mesh_lib.make_test_mesh(1, 1, device=dev)
    ssd_launches = mb["launches"]["ssd_scan"]
    for arch in ("yi_6b", "mamba2_370m"):
        served = phase_lm_mesh_serve(arch, dev, mesh11,
                                     count_prefill=arch == "yi_6b")["mesh"]
        flash_launches += served["launches"]["flash_attention"]
        ssd_launches += served["launches"]["ssd_scan"]
        if arch == "yi_6b":
            phase_launch_dryrun(dry, served)
    phase_lm_train_yi_6b(dev)
    data1 = mesh_lib.data_mesh(device=dev)
    phase_lm_train_mamba2_370m(dev, data1)
    phase_lm_mesh_train(dev, mesh11, data1)
    dist.destroy_process_group()
    phase_lm_train_small_vs_cpu(dev)

    print(json.dumps({"kernels": [{
        "name": "gmm_estep_nodes", "route": "cuda",
        "source": "src/repro_torch/csrc/gmm_estep.cu",
        "replaces": "src/repro/kernels/gmm_estep.py:118",
        # the main path's launches, the sparse main path's, the serving
        # fleets' and the mesh executor's (mesh_main_path,
        # mesh_serve_fleet, mesh_sparse: the register path runs all of
        # them), the worst error of the three shapes
        "launches": mp["launches"] + sparse["launches"]
        + fleet["launches"] + mesh,
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
        # Yi-6B's, RecurrentGemma-2B's, Granite-MoE's and Qwen2-VL's
        # serving launches, and Yi-6B's through Engine(mesh=); the worse
        # error of the sweep, Yi-6B's prefill
        # shape and hd 256 (RecurrentGemma-2B's); timed at Yi-6B's shape
        "launches": flash_launches,
        "max_abs_err": max(lm_err["flash_attention"], hd256["max_abs_err"]),
        "max_err": max(lm_err["flash_attention"], hd256["max_abs_err"]),
        "ms": fa["ms"],
        "plain_ms": fa["plain_ms"], "bound_ms": fa["bound_ms"],
        "bound_by": fa["bound_by"], "library_ms": fa["library_ms"]}, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:74",
        # Mamba-2's serving launches, unsharded and through Engine(mesh=)
        "launches": ssd_launches,
        "max_abs_err": lm_err["ssd_scan"], "max_err": lm_err["ssd_scan"],
        "ms": sd["ms"], "plain_ms": sd["plain_ms"],
        "bound_ms": sd["bound_ms"], "bound_by": sd["bound_by"],
        "library_ms": None}]}), flush=True)
    print(dev_info["smi"], flush=True)
    print(json.dumps({"ok": True, "device": dev_info["info"]}), flush=True)


if __name__ == "__main__":
    main()
