"""The control of a cell's correctness check: the plain reference put in
the program's place and computed one precision lower than the
configuration states (float32 iterates and post-stage for its float64
ones), read by the same numbers as the program.  A sound check reads it
as not correct.

    python3 vbbench/control.py --workload <cell> --seeds 1,2,3

prints one JSON line a seed with each check's reading for the control,
at the cell's own size (on the card).  The benchmark's own runs never
run it; vbbench/tests/test_vbbench_control.py runs it at a small size.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (HERE.parent / "src", HERE.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

from vbbench import harness  # noqa: E402
from vbbench.drivers import batch_vb, fleet_closed_loop  # noqa: E402


def batch_control(cell: dict, seed: int, dev) -> dict:
    cfg, mix = cell["config"], cell["traffic"]
    steps = batch_vb.check_steps(mix)
    inp = batch_vb.make_inputs(cfg, seed, dev)
    iters = [t for _, t in steps]
    low = batch_vb.reference_steps(cfg, mix, inp, iters, torch.float32, dev)
    ref = batch_vb.reference_steps(cfg, mix, inp, iters, torch.float64, dev)
    return {name: value for name, value, _ in batch_vb.step_checks(
        steps, low, ref, cell["workload"]["limits"], cfg["K"], cfg["D"])}


def fleet_control(cell: dict, seed: int, dev) -> dict:
    """The sessions a run would sample, drawn as `pick_sample` draws
    them, from the first 81 sessions (three of each combination)."""
    from vbbench.data import synth
    cfg, mix = cell["config"], cell["traffic"]
    done = [(s,) for s in range(81)]
    sessions = [done[i][0] for i in fleet_closed_loop.pick_sample(
        mix, seed, done)]
    u, v = synth.graph_edges(cfg, cfg["n_nodes"], dev, seed, 2)
    m_init = synth.init_means(cfg, seed)
    args = (cfg, mix, seed, sessions, m_init, u, v)
    low = fleet_closed_loop.reference_sessions(*args, torch.float32, dev)
    ref = fleet_closed_loop.reference_sessions(*args, torch.float64, dev)
    return {name: value for name, value, _ in
            fleet_closed_loop.session_checks(
                sessions, low, ref, cell["workload"]["limits"], mix,
                cfg["K"], cfg["D"])}


CONTROLS = {"batch_vb": batch_control, "fleet_closed_loop": fleet_control}


def control(cell: dict, seed: int, dev) -> dict:
    return CONTROLS[cell["traffic"]["driver"]](cell, seed, dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("vbbench control: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        got = control(cell, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": got,
                          "limits": cell["workload"]["limits"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
