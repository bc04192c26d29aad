"""The LM kernel wrappers' host time per call on the card, for one or
more checkouts in turn.

    python3 tools/kernel_host_cost.py build/parent . . build/parent

For each checkout (a repository root) a process of its own imports that
tree's `repro_torch`, builds its flash_attention and ssd_scan kernels
and times `ops.flash_attention` and `ops.ssd_scan` (telemetry off, as on
the main path) at tiny bf16 shapes, where the kernel takes a few
microseconds and the host is the limit: CALLS back-to-back calls
between two synchronisations, the wall time over the count, the median
of REPS such runs.  So the number is the wrapper's host cost a call:
validation, the custom-op dispatch (since the launches became custom
ops), the library call and the launch.  Give the parent first and last
and the change twice between (parent, change, change, parent) and
compare within the one call.  Prints one JSON line a checkout, then the
card's name and power limit.
"""
from __future__ import annotations

import os
import subprocess
import sys

CALLS, REPS = 2000, 7

_WORKER = r"""
import json, statistics, sys, time
import torch
from repro_torch.kernels import build, ops
CALLS, REPS = int(sys.argv[1]), int(sys.argv[2])
build.build_all(["flash_attention", "ssd_scan"])
dev = torch.device("cuda")
g = torch.Generator(dev).manual_seed(0)
q, k, v = (torch.randn((1, 64, h, 64), generator=g, device=dev,
                       dtype=torch.bfloat16) for h in (2, 1, 1))
x = torch.randn((1, 64, 2, 16), generator=g, device=dev,
                dtype=torch.bfloat16)
dt = torch.rand((1, 64, 2), generator=g, device=dev) * 0.1
A = -torch.rand((2,), generator=g, device=dev)
Bm, Cm = (torch.randn((1, 64, 16), generator=g, device=dev,
                      dtype=torch.bfloat16) for _ in range(2))
calls = {"flash_attention": lambda: ops.flash_attention(q, k, v),
         "ssd_scan": lambda: ops.ssd_scan(x, dt, A, Bm, Cm, chunk=64)}
out = {"root": sys.argv[3]}
with torch.inference_mode():
    for name, fn in calls.items():
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        runs = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) / CALLS * 1e6)
        out[name + "_host_us"] = statistics.median(runs)
        out[name + "_host_us_range"] = [min(runs), max(runs)]
print(json.dumps(out), flush=True)
"""


def main(roots):
    for root in roots:
        root = os.path.abspath(root)
        env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
        proc = subprocess.run(
            [sys.executable, "-c", _WORKER, str(CALLS), str(REPS), root],
            capture_output=True, text=True, env=env, cwd=root)
        if proc.returncode != 0:
            raise RuntimeError(f"{root}: rc {proc.returncode}\n"
                               f"{proc.stderr[-4000:]}")
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main(sys.argv[1:] or ["."])
