"""The mesh executor's collectives (repro_torch.dist) on gloo ranks.

Each world size's ranks are started once, as worker processes (one torch
thread, no jax), over a file store in the test's directory; they run
every case and hand their arrays back through an .npz a rank.  Against
numpy:

* the tiled all-gather (dim 0 and the node axis -2 of a fleet stack),
  `psum`, `pmean`, `axis_index` / `axis_size`, `local_rows`, `ppermute`
  (a rank no pair names receives zeros);
* `ring_combine` (one row a rank) and `ring_combine_block` (a block of
  nodes a rank) against `W @ x` with
  `nearest_neighbor_weights(ring_graph(8))`, as tests/test_distributed.py
  checks the reference's;
* a one-rank group over a `HashStore` (`admission.data_axis_mesh`,
  gloo on the CPU): every collective is the identity.

`launch_ranks` is the launcher the other tests/test_torch_mesh_*.py
files use.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every rank: one intra-op thread, a gloo group over a file store, the
# executor over the default group, `put` to return arrays, `INPUTS` (an
# optional .npz written by the test process); a one-rank run makes its
# group with `admission.data_axis_mesh` (a HashStore) instead
PRELUDE = r'''
import os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK = int(os.environ["MESH_RANK"])
WORLD = int(os.environ["MESH_WORLD"])
if os.environ.get("MESH_HASHSTORE"):
    from repro_torch.serving import admission
    EX = admission.data_axis_mesh(device="cpu")
else:
    dist.init_process_group(
        "gloo", init_method="file://" + os.environ["MESH_STORE"],
        rank=RANK, world_size=WORLD)
    from repro_torch.dist import MeshExecutor
    EX = MeshExecutor()
INPUTS = (dict(np.load(os.environ["MESH_INPUTS"]))
          if os.environ.get("MESH_INPUTS") else {})
OUT = {}


def put(name, a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    OUT[name] = np.asarray(a)
'''

EPILOGUE = r'''
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
np.savez(os.environ["MESH_OUT"], **OUT)
dist.destroy_process_group()
'''


class Ranks:
    """`world` worker processes running one code string; `result()`
    waits for them (once) and returns rank 0's arrays, after checking
    that every rank returned the same arrays bit for bit (the executor
    is SPMD: every rank ends with the whole result).  Names starting
    with "rank/" are a rank's own and are not compared."""

    def __init__(self, code: str, world: int, workdir, inputs=None,
                 hashstore: bool = False, timeout: float = 240.0):
        os.makedirs(workdir, exist_ok=True)
        self.world, self.timeout = world, timeout
        self.outs = [os.path.join(workdir, f"rank{r}.npz")
                     for r in range(world)]
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                   MESH_WORLD=str(world),
                   MESH_STORE=os.path.join(workdir, "store"),
                   GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
        if hashstore:
            env["MESH_HASHSTORE"] = "1"
        if inputs is not None:
            env["MESH_INPUTS"] = os.path.join(workdir, "inputs.npz")
            np.savez(env["MESH_INPUTS"], **inputs)
        source = PRELUDE + code + EPILOGUE
        self.procs = [subprocess.Popen(
            [sys.executable, "-c", source], cwd=REPO,
            env=dict(env, MESH_RANK=str(r), MESH_OUT=self.outs[r]),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]
        self._result = None

    def result(self) -> dict:
        if self._result is not None:
            return self._result
        logs = []
        try:
            for p in self.procs:
                out, err = p.communicate(timeout=self.timeout)
                logs.append((p.returncode, out, err))
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (rc, out, err) in enumerate(logs):
            assert rc == 0, f"rank {r} of {self.world}: rc {rc}\n{out}\n{err}"
        got = [dict(np.load(f)) for f in self.outs]
        for r, other in enumerate(got[1:], 1):
            shared = sorted(k for k in got[0] if not k.startswith("rank/"))
            assert shared == sorted(k for k in other
                                    if not k.startswith("rank/")), r
            for k in shared:
                np.testing.assert_array_equal(other[k], got[0][k],
                                              err_msg=f"rank {r}: {k}")
        self._result = dict(got[0], ranks=got)
        return self._result


def launch_ranks(code, world, workdir, **kw) -> Ranks:
    """Start `world` gloo ranks on `code` (see `Ranks`)."""
    return Ranks(code, world, workdir, **kw)


CODE = r'''
from repro_torch.core import network
from repro_torch.dist import collectives as C

n_local = max(2, 4 // WORLD)                     # a ring of >= 4 nodes
g = (torch.arange(WORLD * n_local * 3, dtype=torch.float64).reshape(
    WORLD * n_local, 3) + 1.0) / 7.0
x = C.local_rows(g, n_local, EX)                 # this rank's block
put("rank/index", C.axis_index(EX))
put("size", C.axis_size(EX))
put("gather", C.all_gather(x, EX))
fleet = torch.stack([g, 2.0 * g + 1.0])          # (S, N, P)
put("gather_fleet", C.all_gather(C.local_rows(fleet, n_local, EX, -2),
                                 EX, -2))
put("gather_int", C.all_gather(torch.tensor([RANK], dtype=torch.int64),
                               EX))
put("psum", C.psum(x, EX))
put("pmean", C.pmean(x, EX))
put("psum_int", C.psum(torch.tensor(RANK + 1, dtype=torch.int32), EX))
# (i -> i + 2) on the first half of the ranks only: the rest get zeros
shift = [(i, (i + 2) % WORLD) for i in range(WORLD // 2)]
put("ppermute", C.all_gather(C.ppermute(x, EX, shift), EX))
row = g[RANK:RANK + 1]                           # one row a rank
put("ring_combine", C.all_gather(C.ring_combine(row, EX), EX))
put("ring_combine_block", C.all_gather(C.ring_combine_block(x, EX), EX))
put("ring_block_fleet", C.all_gather(C.ring_combine_block(
    C.local_rows(fleet, n_local, EX, -2), EX, 0.5), EX, -2))
put("ring_w", network.nearest_neighbor_weights(
    network.ring_graph(WORLD * n_local)))
put("ring_w_ranks", network.nearest_neighbor_weights(
    network.ring_graph(WORLD)) if WORLD > 2 else np.zeros(0))
'''


@pytest.fixture(scope="module", params=[1, 2, 4])
def ranks(request, tmp_path_factory):
    world = request.param
    return world, launch_ranks(
        CODE, world, tmp_path_factory.mktemp(f"collectives{world}"),
        hashstore=world == 1).result()


def _global(world):
    n = world * max(2, 4 // world)
    return (np.arange(n * 3, dtype=np.float64).reshape(n, 3) + 1.0) / 7.0


def test_gather_psum_pmean(ranks):
    world, out = ranks
    g = _global(world)
    assert int(out["size"]) == world
    assert [int(r["rank/index"]) for r in out["ranks"]] == list(range(world))
    np.testing.assert_array_equal(out["gather"], g)
    np.testing.assert_array_equal(out["gather_fleet"],
                                  np.stack([g, 2.0 * g + 1.0]))
    np.testing.assert_array_equal(out["gather_int"], np.arange(world))
    blocks = g.reshape(world, -1, 3)
    np.testing.assert_allclose(out["psum"], blocks.sum(0), rtol=1e-14)
    np.testing.assert_allclose(out["pmean"], blocks.sum(0) / world,
                               rtol=1e-14)
    assert int(out["psum_int"]) == world * (world + 1) // 2
    if world == 1:                   # the one-rank group is the identity
        np.testing.assert_array_equal(out["psum"], g)
        np.testing.assert_array_equal(out["pmean"], g)


def test_ppermute(ranks):
    world, out = ranks
    blocks = _global(world).reshape(world, -1, 3)
    want = np.zeros_like(blocks)
    for i in range(world // 2):
        want[(i + 2) % world] = blocks[i]
    np.testing.assert_array_equal(out["ppermute"], want.reshape(-1, 3))


def test_ring_combines_are_eq47_on_a_ring(ranks):
    world, out = ranks
    g = _global(world)
    W = out["ring_w"]
    np.testing.assert_allclose(out["ring_combine_block"], W @ g,
                               rtol=1e-14)
    # one row a rank: the ranks are the ring's nodes
    rows = g[:world]
    left, right = np.roll(rows, 1, 0), np.roll(rows, -1, 0)
    np.testing.assert_allclose(out["ring_combine"],
                               rows / 3.0 + (left + right) / 3.0,
                               rtol=1e-14)
    if world > 2:
        np.testing.assert_allclose(out["ring_combine"],
                                   out["ring_w_ranks"] @ rows, rtol=1e-14)
    # a fleet stack (S, N, P), w_self = 1/2: each slot its own ring
    fleet = np.stack([g, 2.0 * g + 1.0])
    want = 0.5 * fleet + 0.25 * (np.roll(fleet, 1, 1) + np.roll(fleet, -1,
                                                                 1))
    np.testing.assert_allclose(out["ring_block_fleet"], want, rtol=1e-14)
