"""The mesh executor's collectives on one card, under the one-rank NCCL
group of `admission.data_axis_mesh()`: what each costs the host and the
device, and where a serving fleet's time goes with and without the
executor.

    python3 tools/mesh_collective_probe.py            # the collectives
    python3 tools/mesh_collective_probe.py --fleet    # and serving group C

Prints one JSON line a measurement, each with the card's name and power
limit:

* per collective (psum and pmean of a (4,) f64 vector, the all-gather of
  a (1000, 15) f64 stack on dim 0 and of a (4, 1000, 15) fleet stack on
  the node axis, a ring exchange, which is local on one rank): host us a
  call back to back (a sync after the loop), whether a call waits for
  the device (its host time right behind a ~20 ms matmul queued on the
  stream), and the device events a call adds (torch.profiler, by name);
* with --fleet, chip_smoke.py's serving group C (4 rings of 1000 sensors
  x 4096 points with link drops, 100 iterations, 25-iteration slices)
  on the single-array executor and the executor in turns, 7 runs each:
  ms per fleet iteration, and the host functions whose own time the
  executor's run adds (cProfile of one run each, top 12 by difference).

The process group's environment (TORCH_NCCL_*) is printed beside it.
"""
from __future__ import annotations

import cProfile
import json
import os
import pstats
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.dist import collectives  # noqa: E402
from repro_torch.serving import admission  # noqa: E402

CALLS, REPS = 1000, 7
CARD = "no card"            # nvidia-smi's name and power limit (main)


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def emit(what: str, **fields) -> None:
    print(json.dumps({"probe": what, "card": CARD, **fields}), flush=True)


def _host_us(fn) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    host = (time.perf_counter() - t0) * 1e6 / CALLS
    torch.cuda.synchronize()
    return host


def _waits(fn) -> dict:
    """Host ms of one call right behind a ~20 ms matmul queued on the
    stream: ~0 if the call only queues work, ~20 if it waits."""
    a = torch.randn(8192, 8192, device="cuda")
    a @ a
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        a @ a
    queued = time.perf_counter()
    fn()
    called = time.perf_counter()
    torch.cuda.synchronize()
    done = time.perf_counter()
    return {"call_ms": (called - queued) * 1e3,
            "queue_ms": (queued - t0) * 1e3,
            "device_left_ms": (done - called) * 1e3}


def _device_events(fn, n: int = 20) -> dict:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.count / n for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)}


def probe_collectives(ex) -> None:
    dev = torch.device("cuda")
    vec = torch.randn(4, dtype=torch.float64, device=dev)
    stack = torch.randn(1000, 15, dtype=torch.float64, device=dev)
    fleet = torch.randn(4, 1000, 15, dtype=torch.float64, device=dev)
    cases = {
        "psum_4": lambda: collectives.psum(vec, ex),
        "pmean_4": lambda: collectives.pmean(vec, ex),
        "all_gather_1000x15": lambda: collectives.all_gather(stack, ex),
        "all_gather_fleet_node_axis": lambda: collectives.all_gather(
            fleet, ex, -2),
        "ring_boundaries_fleet": lambda: collectives.ring_boundaries(
            fleet, ex),
        "clone_4 (baseline)": lambda: vec.clone(),
    }
    for name, fn in cases.items():
        emit("collective", case=name, host_us_per_call=_host_us(fn),
             behind_matmul=_waits(fn), device_events_per_call=_device_events(
                 fn))


def probe_fleet(ex) -> None:
    import chip_smoke as cs
    from repro_torch.data import synthetic
    from repro_torch.serving import vb_service

    dev = torch.device("cuda")
    inst = cs._instance(cs.N_NODES, cs.N_PER_NODE, dev)
    data = []
    for s in range(4):
        d = synthetic.paper_synthetic(n_nodes=cs.N_NODES,
                                      n_per_node=cs.N_PER_NODE, seed=s,
                                      dtype=np.float32)
        data.append((d.x.to(dev), d.mask.to(dev)))
    reqs = cs._fleet_requests(inst, data * 3, dev)["C"]

    def serve(executor):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc = vb_service.VBService(slice_iters=cs.FLEET_SLICE,
                                   max_fleet=cs.FLEET_MAX, executor=executor,
                                   device=dev)
        for r, a in reqs:
            svc.submit(r, arrive_at=a)
        svc.run()
        torch.cuda.synchronize()
        st = svc.stats()
        return (time.perf_counter() - t0) * 1e3 / (st.slices
                                                   * cs.FLEET_SLICE)

    serve(None)
    serve(ex)
    ms = {"single": [], "mesh": []}
    for _ in range(REPS):
        for mode, executor in (("single", None), ("mesh", ex)):
            ms[mode].append(serve(executor))
    own = {}
    for mode, executor in (("single", None), ("mesh", ex)):
        prof = cProfile.Profile()
        prof.runcall(serve, executor)
        stats = pstats.Stats(prof).stats
        own[mode] = {f"{os.path.basename(k[0])}:{k[1]}({k[2]})": v[2]
                     for k, v in stats.items()}
    added = sorted(((k, own["mesh"][k] - own["single"].get(k, 0.0))
                    for k in own["mesh"]), key=lambda kv: -kv[1])[:12]
    emit("fleet_c", runs=REPS, ms_per_fleet_iter={
        m: {"median": float(np.median(v)), "min": float(min(v)),
            "max": float(max(v)), "all": v} for m, v in ms.items()},
         host_own_seconds_added=[[k, v] for k, v in added])


def main() -> None:
    global CARD
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    CARD = _card()
    ex = admission.data_axis_mesh(device="cuda")
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         nccl=str(torch.cuda.nccl.version()),
         nccl_env={k: v for k, v in os.environ.items()
                   if k.startswith(("TORCH_NCCL", "NCCL"))})
    probe_collectives(ex)
    if "--fleet" in sys.argv[1:]:
        probe_fleet(ex)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
