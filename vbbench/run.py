"""One run of one benchmark cell of the PyTorch and CUDA port.

    python3 vbbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell's files by name (vbbench/harness.py), makes its inputs on
the card from the seed, sets up and warms up the program, measures for
`--seconds`, checks what the timed path produced against the plain
reference, and prints one JSON line: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer metrics), `device` (and with `--trace 1` a `breakdown` of the
traced window), and last `checks`, each compared number beside its
limit.  Exits non-zero, printing no result, without a CUDA card (or
with fewer than the cell asks for), or if JAX or the JAX package was
loaded in the process.

The program's kernels build once into build/repro_torch/ inside the
checkout (`repro_torch.kernels.build`); later runs load them from there.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
for p in (HERE.parent / "src", HERE.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from vbbench import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(args, device=None, root: Path = harness.ROOT,
            t_start: float = T_START) -> dict | None:
    """Run the cell; returns the result line's fields (with the checks
    under "checks_list"), or None when no card can run it.  `device`
    given (tests on the CPU) skips the look for a card."""
    import torch

    spec = harness.bench_spec(root)
    entry = [w for w in spec["workloads"] if w["name"] == args.workload]
    if not entry:
        raise SystemExit(f"no workload {args.workload!r} in BENCHMARK.json")
    chips = int(entry[0]["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"vbbench: {args.workload} needs {chips} CUDA card(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return None
        device = torch.device("cuda", 0)
    torch.set_num_threads(1)
    cell = harness.cell(args.workload, root)
    driver = harness.load_module("drivers", cell["traffic"]["driver"], root)
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                     device, t_start)

    metrics = {}
    if not args.trace:
        for m in harness.cell_metrics(spec, args.workload, "end_to_end"):
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in harness.cell_metrics(spec, args.workload, "per_layer"):
            value = harness.metric_reader(m["name"], root)(out["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = torch.device(device).type == "cuda"
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                "count": chips,
                "memory_peak_bytes": out["memory_peak_bytes"]}
    if args.trace:
        dev_info["busy_s"] = out["trace"]["busy_s"]
        dev_info["window_s"] = out["trace"]["window_s"]
    result = {"correct": harness.correct(out["checks"]),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev_info}
    if args.trace:
        result["breakdown"] = harness.breakdown(out["trace"])
    result["checks_list"] = out["checks"]
    return result


def main(argv=None, device=None, root: Path = harness.ROOT) -> int:
    """The command; `device` and `root` let tests on the CPU drive a run
    of a cell laid out under another root."""
    args = parse(argv)
    result = execute(args, device, root)
    if result is None:
        return 2
    bad = harness.forbidden_modules()
    if bad:
        print(f"vbbench: modules loaded that the port must not load: {bad}",
              file=sys.stderr)
        return 3
    checks = result.pop("checks_list")
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
