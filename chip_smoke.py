"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card (an H100 for
the numbers in PERF.md).  It imports only the port (`src/repro_torch`),
never JAX or the JAX package, and prints one JSON line per phase:

1. device — the card, its power limit (nvidia-smi), the TF32 switches
   (both set off);
2. build — compiles every kernel from src/repro_torch/csrc with nvcc and
   reports the build seconds and ptxas's registers/shared memory/spills;
3. kernel_vs_plain — each kernel against its plain PyTorch version on the
   card, at the tests/test_kernels.py sweep shapes, K=32/D=3 and the main
   path's shape (f32 and bf16 x), with ragged masks, r on and off and a
   replication factor; plus bit-equality under trailing zero padding and
   across two launches;
4. main_path — the paper's five estimators through algorithms.run_* with
   backend="fused" at N=1000 sensors x 4096 points (K=3, D=2): finite
   results, one kernel launch per iteration, cVB and dSVB matched against
   backend="reference", ms per iteration, the kernel's time against its
   bound, peak device memory, and (reported only) what cVB gives with f32
   iterates instead of the main path's f64 ones;
5. small_vs_cpu — the same five estimators on a small instance, card
   (fused kernel) against CPU (plain version);
6. profile — device-busy time by kernel over ten fused dSVB iterations
   against the host wall clock (torch.profiler);

then the kernels line and, last, {"ok": true, "device": {...}}.  Any
failure raises and exits non-zero before the last line.  Without a card
it fails at once.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.gmm_sensor import GMMSensorConfig  # noqa: E402
from repro_torch.core import algorithms, expfam, gmm, network  # noqa: E402
from repro_torch.core import refperm  # noqa: E402
from repro_torch.core.engine import kl_to_reference  # noqa: E402
from repro_torch.core.model import GMMModel  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import build, gmm_estep, ops  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, f32 outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

# The main path: the paper's experiment at deployment size (ISSUE/PERF.md)
N_NODES, N_PER_NODE, SEED = 1000, 4096, 0
ITERS = {"cvb": 50, "noncoop": 50, "nsg_dvb": 50, "dsvb": 200,
         "dvb_admm": 200}
# tests/test_kernels.py tolerances: r, R, sum_x, sum_xx
TOL = {"r": (0.0, 2e-5), "R": (1e-4, 1e-4), "sum_x": (1e-4, 5e-4),
       "sum_xx": (1e-3, 5e-3)}


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
    (gmm_estep_nodes_kernel<D, x dtype>)."""
    rows, cur = [], None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '.*?kernelILi(\d+)E(\w+?)E",
                      ln)
        if m:
            cur = {"D": int(m.group(1)),
                   "x": "bf16" if "bfloat16" in m.group(2) else "f32"}
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


def phase_build():
    built = build.build("gmm_estep", force=True)
    emit("build", kernel="gmm_estep", seconds=round(built.seconds, 3),
         library=os.path.relpath(built.path, HERE),
         ptxas=_ptxas_table(built.report))


# ---------------------------------------------------------------------------
# 3. kernel vs plain version
# ---------------------------------------------------------------------------
def _random_terms(N, K, D, dev, rng):
    A = rng.normal(size=(N, K, D, D)) * 0.3
    terms = (rng.normal(size=(N, K)),
             np.einsum("nkij,nklj->nkil", A, A) + np.eye(D),
             rng.normal(size=(N, K, D)), rng.uniform(1, 3, (N, K)))
    return [torch.tensor(t, dtype=torch.float32, device=dev) for t in terms]


def _compare(got, want) -> float:
    """Assert the tests/test_kernels.py tolerances; returns the max
    absolute error over all outputs."""
    err = 0.0
    for name, g, w in zip(("r", "R", "sum_x", "sum_xx"), got, want):
        if g is None or w is None:
            if (g is None) != (w is None):
                raise AssertionError(f"{name}: one version returned None")
            continue
        rtol, atol = TOL[name]
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol,
                                   msg=lambda m: f"{name}: {m}")
        err = max(err, float((g - w).abs().max()))
    return err


def phase_kernel_vs_plain(main_x, main_mask, dev):
    rng = np.random.default_rng(0)
    cases = []
    # the tests/test_kernels.py sweep shapes, then K=32/D=3
    for N, T, K, D in ((1, 100, 3, 2), (1, 257, 4, 5), (1, 64, 2, 8),
                       (1, 500, 6, 3), (4, 300, 32, 3)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.tensor(rng.normal(size=(N, T, D)) * 2, dtype=dtype,
                             device=dev)
            mask = torch.tensor(rng.random((N, T)) > 0.2, dtype=dtype,
                                device=dev)
            terms = _random_terms(N, K, D, dev, rng)
            for return_r in (True, False):
                args = (x, mask, *terms, 3.0)
                err = _compare(
                    ops.gmm_estep_nodes(*args, return_r=return_r),
                    gmm_estep.gmm_estep_nodes_plain(*args,
                                                    return_r=return_r))
                cases.append({"shape": [N, T, K, D], "x": str(dtype)[6:],
                              "return_r": return_r, "max_abs_err": err})
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
            err = _compare(
                ops.gmm_estep_nodes(*args, shift=s, return_r=return_r),
                gmm_estep.gmm_estep_nodes_plain(*args, shift=s,
                                                return_r=return_r))
            cases.append({"shape": [N, T, 3, 2],
                          "x": str(dtype)[6:], "return_r": return_r,
                          "shift": s is not None, "max_abs_err": err})
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
    torch.cuda.synchronize()
    emit("kernel_vs_plain", tolerance=TOL, cases=cases,
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


def phase_main_path(inst, dev) -> dict:
    cfg, x, mask, adj, W, prior, ref, init_q = inst
    torch.cuda.reset_peak_memory_stats()

    # warm-up (library handles, first launches) outside the timed window
    _estimate("cvb", *inst, "fused", 2, dev)
    torch.cuda.synchronize()
    results, ms_per_iter = {}, {}
    ops.gmm_estep_nodes.launches = 0              # the main path's window
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
    err = _compare(ops.gmm_estep_nodes(x, mask, *terms, shift=shift),
                   gmm_estep.gmm_estep_nodes_plain(x, mask, *terms,
                                                   shift=shift))
    args = (x, mask, *terms, float(N_NODES))
    kernel_ms = graph_time_ms(lambda: ops.gmm_estep_nodes(
        *args, shift=shift, return_r=False), 20)
    call_ms = time_ms(lambda: ops.gmm_estep_nodes(
        *args, shift=shift, return_r=False), 100)
    plain_ms = time_ms(lambda: gmm_estep.gmm_estep_nodes_plain(
        *args, shift=shift, return_r=False), 10)
    K, D, T = cfg.K, cfg.D, N_PER_NODE
    n_bytes = (x.numel() * x.element_size() + mask.numel() * 4
               + sum(t.numel() * 4 for t in (*terms, shift))
               + N_NODES * (K + K * D + K) * D * 4)
    # per point and component: centring, log rho (y'Wy, y.b, combine),
    # softmax, and the R / sum_x / upper-triangle sum_xx accumulations
    flops = N_NODES * T * K * (D + 2 * D * D + 4 * D + 8
                               + 1 + 2 * D + 3 * D * (D + 1) // 2)
    bound = {"bytes": n_bytes / PEAK_BYTES_PER_S * 1e3,
             "operations": flops / PEAK_F32_FLOP_PER_S * 1e3}
    bound_by = max(bound, key=bound.get)
    emit("main_path_kernel", kernel="gmm_estep_nodes",
         max_abs_err_engine_terms=err, ms=kernel_ms,
         call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound[bound_by],
         bound_by=bound_by, bytes=n_bytes, flops=flops,
         achieved_GBps=n_bytes / kernel_ms / 1e6,
         max_memory_allocated=peak)
    phase_precision(inst, ref_runs["cvb"], dev)
    return {"launches": launches, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound[bound_by], "bound_by": bound_by,
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
def phase_profile(inst, dev, n_iters: int = 10):
    """Trace `n_iters` fused dSVB iterations: device-busy time by kernel
    against the host wall clock (the profiler's own overhead inflates the
    wall time, so the idle share is an upper bound)."""
    from torch.profiler import ProfilerActivity, profile
    _estimate("dsvb", *inst, "fused", 2, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _estimate("dsvb", *inst, "fused", n_iters, dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    emit("profile", estimator="dsvb", backend="fused", n_iters=n_iters,
         wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_idle_share=1.0 - busy_ms / wall_ms,
         kernels_launched=sum(e.count for e in events),
         top=[{"name": e.key[:80], "device_ms": e.self_device_time_total
               / 1e3, "count": e.count} for e in top])


def main():
    dev_info = phase_device()
    phase_build()
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
    mp = phase_main_path(inst, dev)
    phase_small_vs_cpu(dev)
    phase_profile(inst, dev)
    print(json.dumps({"kernels": [{
        "name": "gmm_estep_nodes", "route": "cuda",
        "source": "src/repro_torch/csrc/gmm_estep.cu",
        "replaces": "src/repro/kernels/gmm_estep.py:118",
        "launches": mp["launches"], "max_abs_err": mp["max_abs_err"],
        "max_err": mp["max_abs_err"], "ms": mp["ms"],
        "plain_ms": mp["plain_ms"], "bound_ms": mp["bound_ms"],
        "bound_by": mp["bound_by"], "library_ms": None}]}), flush=True)
    print(dev_info["smi"], flush=True)
    print(json.dumps({"ok": True, "device": dev_info["info"]}), flush=True)


if __name__ == "__main__":
    main()
