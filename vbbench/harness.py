"""The benchmark's shared machinery: finding a cell's files by name,
tracing a window on the device, and writing the result line.

Everything a cell is made of lives in a file of its own, found by name:

* `workloads/<cell>.json`  the cell: its configuration, traffic mix and
  the limits of its correctness numbers;
* `configs/<config>.json`  the deployment's sizes and hyperparameters;
* `traffic/<traffic>.json` the mix: which driver runs it and its
  parameters;
* `drivers/<driver>.py`    the general generator and driver of a kind of
  traffic (`run(cell, seed, seconds, trace, device, t_start)`);
* `metrics/<metric>.py`    a per-layer reader (`read(ctx)`), looked up by
  the metric's whole name, then by the part before its first dot (the
  suffix names the end-to-end metric it moves).

Which end-to-end and per-layer metrics a cell reports comes from
`BENCHMARK.json` at the checkout's root.
"""
from __future__ import annotations

import bisect
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(kind: str, name: str, root: Path = ROOT) -> dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str, root: Path = ROOT):
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    mod_name = f"vbbench_{kind}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str, root: Path = ROOT) -> dict:
    """The cell `name` with its configuration and traffic mix."""
    wl = load_json("workloads", name, root)
    return {"name": name, "workload": wl,
            "config": load_json("configs", wl["config"], root),
            "traffic": load_json("traffic", wl["traffic"], root)}


def metric_reader(name: str, root: Path = ROOT):
    """The per-layer reader of `name`: metrics/<name>.py, else
    metrics/<part before the first dot>.py."""
    base = name.split(".", 1)[0]
    for stem in (name, base):
        if (root / "metrics" / f"{stem}.py").is_file():
            return load_module("metrics", stem, root).read
    raise FileNotFoundError(f"no reader for metric {name!r}")


def bench_spec(root: Path = ROOT) -> dict:
    return json.loads((root.parent / "BENCHMARK.json").read_text())


def cell_metrics(spec: dict, cell_name: str, kind: str) -> list:
    """The `end_to_end` or `per_layer` entries this cell reports."""
    return [m for m in spec[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX, its
    relatives, or the JAX package of this repository."""
    return sorted({n.split(".", 1)[0] for n in sys.modules}
                  & set(FORBIDDEN))


def open_window() -> float:
    """Collect once and freeze what set-up left (imports, buffers): the
    interpreter's full collections then scan only what the window makes,
    so none of them stalls a host-paced loop for the whole heap.  Returns
    the window's start on the host clock."""
    gc.collect()
    gc.freeze()
    return time.perf_counter()


# ---------------------------------------------------------------------------
# the traced window
# ---------------------------------------------------------------------------
def traced(fn) -> dict:
    """Run fn() under torch.profiler (CPU and CUDA activity), synchronise,
    and summarise the device's timeline: busy seconds (the union of the
    device events' intervals), the window's length, every kernel's count
    and seconds by name, and idle gaps by what the host was doing.
    fn returns the number of iterations it ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        sync()
        t0 = time.perf_counter()
        iters = fn()
        sync()
        window_s = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            # the device timeline's mirror of a host range is no device
            # work, nor is CUPTI's mark of a full launch queue
            if (getattr(e, "is_user_annotation", False)
                    or e.name.startswith("vbbench/")
                    or e.name == "Command Buffer Full"):
                continue
            dev.append((e.time_range.start, e.time_range.end, e.name))
        elif e.device_type == DeviceType.CPU and not e.name.startswith(
                ("cuda", "cu", "Activity Buffer")):
            host.append((e.time_range.start, e.time_range.end, e.name))
    dev.sort()
    kernels: dict = {}
    busy_us, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e, name in dev:
        c = kernels.setdefault(name, [0, 0.0])
        c[0] += 1
        c[1] += (e - s) * 1e-6
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy_us += cur_e - cur_s
            gaps.append((s - cur_e, cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    return {"iterations": iters, "window_s": window_s,
            "busy_s": busy_us * 1e-6, "kernels": kernels,
            "n_kernels": len(dev),
            "idle_gaps": _attribute_gaps(gaps, host, window_s,
                                         busy_us * 1e-6)}


def _attribute_gaps(gaps, host, window_s, busy_s, longest: int = 200):
    """[(what the host was doing, idle seconds)], longest first: each of
    the `longest` longest gaps between device events goes to the
    innermost host event (latest start) running at its midpoint; the
    idle time outside the first and last device events is the rest of
    the window."""
    host.sort()
    starts = [h[0] for h in host]
    total: dict = {}
    for dur, a, b in sorted(gaps, reverse=True)[:longest]:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        name = "host (no traced op)"
        for j in range(i, max(i - 4000, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        total[name] = total.get(name, 0.0) + dur * 1e-6
    covered = sum(d for d, _, _ in gaps) * 1e-6
    edge = window_s - busy_s - covered
    if edge > 0:
        total["window edges (before the first or after the last device "
              "op)"] = edge
    return sorted(total.items(), key=lambda kv: kv[1], reverse=True)


def breakdown(trace: dict) -> dict:
    ops = sorted(((n[:120], c[1]) for n, c in trace["kernels"].items()),
                 key=lambda kv: kv[1], reverse=True)[:10]
    return {"device_ops": [list(o) for o in ops],
            "idle_gaps": [[n[:120], s] for n, s in
                          trace["idle_gaps"][:10]]}


def kernel_seconds(trace: dict, part: str) -> tuple:
    """(calls, seconds) of the kernels whose name holds `part`."""
    calls = secs = 0
    for name, (n, s) in trace["kernels"].items():
        if part in name:
            calls += n
            secs += s
    return calls, secs


# ---------------------------------------------------------------------------
# the result line
# ---------------------------------------------------------------------------
def check_line(checks: list) -> dict:
    """{name: {"value", "limit"}} of the numbers compared."""
    return {name: {"value": value, "limit": limit}
            for name, value, limit in checks}


def correct(checks: list) -> bool:
    return all(math.isfinite(v) and v <= lim for _, v, lim in checks)


def emit(result: dict, checks: list) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error; then the result line, with them under `checks`, the
    last key, as the last line on standard output."""
    for name, value, limit in checks:
        ok = "ok" if math.isfinite(value) and value <= limit else "FAIL"
        print(f"check {name} {value!r} limit {limit!r} {ok}",
              file=sys.stderr, flush=True)
    line = dict(result)
    line["checks"] = check_line(checks)
    print(json.dumps(line), flush=True)
