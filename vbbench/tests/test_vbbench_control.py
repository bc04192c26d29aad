"""The control of each cell's check (the plain reference in float32, one
precision below the configuration's float64 iterates, put in the
program's place) reads not correct under the cell's own limits, at a
size a test run holds, on three seeds."""
from __future__ import annotations

import pytest

from vbbench import control, harness
from vbbench.data import synth

SIZES = {"k3d2_100k.dsvb": {"n_nodes": 300, "n_per_node": 256},
         "k3d2_100k.admm": {"n_nodes": 300, "n_per_node": 256},
         "k3d2_1k.fleet64_dsvb": {"n_nodes": 100}}
FLEET = {"caps": [400, 500, 640], "budgets": [100, 200, 400], "sample": 3}


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("workload", sorted(SIZES))
def test_control_reads_not_correct(workload, seed):
    cell = harness.cell(workload)
    cell["config"].update(SIZES[workload])
    side, radius = synth.paper_side_radius(cell["config"]["n_nodes"])
    cell["config"].update(side=side, comm_radius=radius)
    if cell["traffic"]["driver"] == "fleet_closed_loop":
        cell["traffic"].update(FLEET)
    got = control.control(cell, seed, "cpu")
    limits = cell["workload"]["limits"]
    assert set(got) == set(limits)
    checks = [(k, v, limits[k]) for k, v in got.items()]
    assert not harness.correct(checks), checks
