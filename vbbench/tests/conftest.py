"""Fixtures of the benchmark's CPU tests: a copy of the benchmark laid out
under a temporary root, its configurations and mixes cut to sizes a test
run holds, which `run.main(argv, device="cpu", root=...)` drives."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

VBBENCH = Path(__file__).resolve().parents[1]
REPO = VBBENCH.parent
for p in (REPO / "src", REPO):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from vbbench.data import synth  # noqa: E402

SMALL_CONFIG = {"gmm_k3d2_n100k": {"n_nodes": 300, "n_per_node": 256},
                "gmm_k3d2_n1k": {"n_nodes": 30}}
_SMALL_FLEET = {"clients": 6, "max_fleet": 4, "slice_iters": 5,
               "caps": [40, 50, 64], "budgets": [10, 20, 40],
               "warm_ticks": 8, "trace_ticks": 2, "sample": 3}
SMALL_TRAFFIC = {
    "dsvb_batch": {"chunk_iters": 5, "trace_iters": 10},
    "admm_batch": {"chunk_iters": 5, "trace_iters": 10},
    "fleet64_dsvb": _SMALL_FLEET}


def _update(path: Path, fields: dict) -> None:
    data = json.loads(path.read_text())
    data.update(fields)
    path.write_text(json.dumps(data, indent=1))


@pytest.fixture
def small_root(tmp_path) -> Path:
    """tmp/vbbench (a copy) with BENCHMARK.json beside it, every
    configuration and mix cut to a CPU test's size."""
    root = tmp_path / "vbbench"
    shutil.copytree(VBBENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for name, fields in SMALL_CONFIG.items():
        side, radius = synth.paper_side_radius(fields["n_nodes"])
        _update(root / "configs" / f"{name}.json",
                dict(fields, side=side, comm_radius=radius))
    for name, fields in SMALL_TRAFFIC.items():
        _update(root / "traffic" / f"{name}.json", fields)
    return root


def run_line(root: Path, capsys, workload: str, *, seed: int = 2**31 + 11,
             trace: int = 0, seconds: float = 0.5):
    """(exit code, the last stdout line parsed, stderr) of one run of
    `workload` on the CPU under `root`."""
    from vbbench import run
    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], device="cpu",
                  root=root)
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err
