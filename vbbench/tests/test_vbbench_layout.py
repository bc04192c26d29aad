"""The harness finds a cell, a configuration, a traffic mix and a
per-layer metric that are dropped in as new files, with no edit of the
files that are there; and the last line has exactly the contract's
keys."""
from __future__ import annotations

import json
import math

from conftest import run_line

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_last_line_has_the_contract_keys(small_root, capsys):
    for workload, e2e in (("k3d2_100k.dsvb", {"iter_ms", "setup_s"}),
                          ("k3d2_1k.fleet64_dsvb",
                           {"sessions_per_s", "session_p95_s", "setup_s"})):
        rc, line, err = run_line(small_root, capsys, workload)
        assert rc == 0, err
        assert list(line) == KEYS
        assert set(line["metrics"]) == e2e
        assert all(set(m) == {"value", "unit"} and m["value"] > 0
                   for m in line["metrics"].values())
        assert set(line["device"]) == {"platform", "kind", "count",
                                       "memory_peak_bytes"}
        assert line["correct"] is True and line["failed"] == 0
        assert line["attempted"] > 0
        for name, c in line["checks"].items():
            assert set(c) == {"value", "limit"}
            assert math.isfinite(c["value"]) and c["value"] <= c["limit"]
        # the numbers compared are also the last lines on stderr
        tail = err.strip().splitlines()[-len(line["checks"]):]
        assert [t.split()[1] for t in tail] == list(line["checks"])


def test_traced_line_has_breakdown_and_window(small_root, capsys):
    rc, line, err = run_line(small_root, capsys, "k3d2_1k.fleet64_dsvb",
                             trace=1)
    assert rc == 0, err
    assert list(line) == KEYS[:5] + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU only the host-clock and counter metrics have a reading
    assert set(line["metrics"]) == {"slot_occupancy.fleet",
                                    "fleet_iter_ms.fleet"}


def test_new_cell_config_mix_and_metric_are_found(small_root, capsys):
    conf = json.loads((small_root / "configs" /
                       "gmm_k3d2_n100k.json").read_text())
    conf["n_nodes"] = 120
    (small_root / "configs" / "gmm_k3d2_tiny.json").write_text(
        json.dumps(conf))
    mix = json.loads((small_root / "traffic" / "dsvb_batch.json").read_text())
    mix["chunk_iters"] = 3
    (small_root / "traffic" / "dsvb_batch_short.json").write_text(
        json.dumps(mix))
    (small_root / "workloads" / "tiny.dsvb.json").write_text(json.dumps({
        "config": "gmm_k3d2_tiny", "traffic": "dsvb_batch_short",
        "why": "a dropped-in cell",
        "limits": {f"{kind}_step{i}": 1e-3 for kind in ("gap", "tail")
                   for i in (1, 2, 3)}}))
    (small_root / "metrics" / "answer.py").write_text(
        "def read(ctx):\n    return 42.0 if ctx.get('trace') else None\n")
    spec_path = small_root.parent / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    spec["workloads"].append({"name": "tiny.dsvb", "config": "gmm_k3d2_tiny",
                              "traffic": "dsvb_batch_short", "chips": 1,
                              "why": "a dropped-in cell"})
    spec["end_to_end"][0]["workloads"].append("tiny.dsvb")
    spec["per_layer"].append({"name": "answer.iter", "unit": "count",
                              "better": "higher", "source": "program_counter",
                              "layer": "engine", "moves": "iter_ms",
                              "workloads": ["tiny.dsvb"]})
    spec_path.write_text(json.dumps(spec))
    rc, line, err = run_line(small_root, capsys, "tiny.dsvb")
    assert rc == 0, err
    assert set(line["metrics"]) == {"iter_ms", "setup_s"}
    assert line["attempted"] % 3 == 0 and line["correct"] is True
    rc, line, err = run_line(small_root, capsys, "tiny.dsvb", trace=1)
    assert rc == 0, err
    assert line["metrics"]["answer.iter"] == {"value": 42.0, "unit": "count"}
