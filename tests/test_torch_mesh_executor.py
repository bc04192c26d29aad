"""The port's mesh executor (`run_vb(executor=MeshExecutor(group))`) on 2
and 4 gloo ranks, float64, reference backend, on the CPU.

The instance of tests/test_engine.py's executor-equivalence check (8
nodes x 30 points, `paper_synthetic` seed 9, a random geometric graph of
seed 5, 25 iterations), the arrays made by the JAX package and handed to
both: diffusion, ring, ADMM, adaptive ADMM (+ per_block) and the fusion
centre.

* Against the port's single-array run: phi, `consensus_err` and the ADMM
  diagnostics within 1e-8 (the reference's executor bar,
  tests/test_engine.py), the Eq. 46 KLs too.
* Against the JAX package's single-array `engine.run_vb`: rtol 1e-9, the
  bar of the port's f64 parity tests (tests/test_torch_engine.py); the
  fusion centre's consensus error, zero up to the rounding of a mean of
  equal rows, against the scale of phi^2 as there.
* `core/distributed.py`'s runners against the JAX `algorithms.run_dsvb` /
  `run_dvb_admm` (tests/test_distributed.py's instance and its 1e-8).
* Sessions: a `vb_init` / `vb_run` split bit-equal to one run under the
  executor; a mesh session's state saved and restored into a
  single-array session (and back) bit-equal to the state saved, each
  continued run within 1e-8 of the other executor's.
* Errors: N not divisible by the ranks, `metric_nodes`, a group whose
  backend does not serve the device, no group, not an executor.

Every rank returns the same arrays bit for bit (tests/
test_torch_mesh_collectives.py's launcher checks it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithms as ja
from repro.core import engine as je
from repro.core import expfam as jx
from repro.core import model as jm
from repro.core import network as jn
from repro.data import synthetic as js
from repro_torch.core import engine as te
from repro_torch.core import expfam as tx
from repro_torch.core import model as tm
from repro_torch.dist import MeshExecutor
from test_torch_mesh_collectives import launch_ranks

K, D, N_ITERS = 3, 2, 25
EXECUTOR_BAR = 1e-8
PARITY_RTOL = 1e-9

# the topologies, built from either package's engine module
TOPOLOGIES = r'''
def topologies(engine, adj, W):
    return [
        ("diffusion", engine.Diffusion(W), dict(schedule=engine.Schedule())),
        ("ring", engine.RingDiffusion(), dict(schedule=engine.Schedule())),
        ("admm", engine.ADMMConsensus(adj), {}),
        ("admm-adaptive", engine.ADMMConsensus(adj, adaptive_rho=True), {}),
        ("admm-adaptive-pb",
         engine.ADMMConsensus(adj, adaptive_rho=True, per_block=True), {}),
        ("fusion", engine.FusionCenter(), dict(schedule=engine.ONE_SHOT)),
    ]
'''
NAMES = ["diffusion", "ring", "admm", "admm-adaptive", "admm-adaptive-pb",
         "fusion"]

CODE = TOPOLOGIES + r'''
from repro_torch.checkpoint import ckpt
from repro_torch.core import distributed, engine, expfam
from repro_torch.core import model as model_lib
from repro_torch.dist import collectives

I = {k: torch.from_numpy(v) for k, v in INPUTS.items()}
prior = expfam.noninformative_prior(3, 2, beta0=0.1, w0_scale=10.0,
                                    device="cpu")
mdl = model_lib.GMMModel(prior, 3, 2, device="cpu")
data = (I["x"], I["mask"])


def put_run(name, r):
    put(f"{name}/phi", r.phi)
    put(f"{name}/kl_nodes", r.kl_nodes)
    put(f"{name}/kl_mean", r.kl_mean)
    put(f"{name}/consensus_err", r.consensus_err)
    if r.consensus_diag is not None:
        for f, v in r.consensus_diag._asdict().items():
            put(f"{name}/diag/{f}", v)


for name, topo, kw in topologies(engine, I["adj"], I["W"]):
    put_run(name, engine.run_vb(mdl, data, topo, n_iters=25, executor=EX,
                                device="cpu", **kw))

# core/distributed.py (tests/test_distributed.py's instance)
fd, fadj, fW = (I["f_x"], I["f_mask"]), I["f_adj"], I["f_W"]
put("dist/dsvb", distributed.run_dsvb_sharded(
    EX, *fd, fW, prior, n_iters=40, K=3, D=2, device="cpu"))
put("dist/admm", distributed.run_admm_sharded(
    EX, *fd, fadj, prior, n_iters=40, K=3, D=2, device="cpu"))
put("dist/ring", distributed.run_dsvb_ring_sharded(
    EX, *fd, prior, n_iters=40, K=3, D=2, device="cpu"))


# sessions: a split run, checkpoints across the executors
def session(executor):
    return engine.vb_init(mdl, data, engine.ADMMConsensus(
        I["adj"], adaptive_rho=True, per_block=True), executor=executor,
        device="cpu")


def leaves(state):
    lam, rho, stable, t_act, active = state.carry
    return [state.phi, lam, rho, stable, t_act, active,
            *state.diag._asdict().values()]


s0 = session(EX)
whole = engine.vb_run(s0, 25)[0]
s10 = engine.vb_run(s0, 10)[0]
split = engine.vb_run(engine.vb_step(engine.vb_run(s0, 9)[0]), 15)[0]
for i, (a, b) in enumerate(zip(leaves(whole), leaves(split))):
    put(f"split/whole/{i}", a)
    put(f"split/split/{i}", b)
here = os.path.dirname(os.environ["MESH_OUT"])
mesh_file = ckpt.save(os.path.join(here, f"mesh{RANK}.npz"), s10)
into_single = ckpt.restore(mesh_file, session(None))
single10 = engine.vb_run(session(None), 10)[0]
single_file = ckpt.save(os.path.join(here, f"single{RANK}.npz"), single10)
into_mesh = ckpt.restore(single_file, session(EX))
for i, (a, b) in enumerate(zip(leaves(s10), leaves(into_single))):
    put(f"ckpt/mesh/{i}", a)
    put(f"ckpt/into_single/{i}", b)
for i, (a, b) in enumerate(zip(leaves(single10), leaves(into_mesh))):
    put(f"ckpt/single/{i}", a)
    put(f"ckpt/into_mesh/{i}", b)
put("ckpt/t", [into_single.t, into_mesh.t])
put("ckpt/mesh_then_single", engine.vb_run(into_single, 15)[0].phi)
put("ckpt/single_then_mesh", engine.vb_run(into_mesh, 15)[0].phi)
put("ckpt/mesh_whole", whole.phi)


def message(fn):
    try:
        fn()
    except (ValueError, TypeError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


put("err/n_nodes", message(lambda: engine.vb_init(
    mdl, (I["x"][:5], I["mask"][:5]), engine.Isolated(), executor=EX,
    device="cpu")))
put("err/backend", message(lambda: collectives.check_device(
    EX, torch.device("cuda"))))
'''


@pytest.fixture(autouse=True, scope="module")
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _topologies(engine, adj, W):
    ns = {}
    exec(TOPOLOGIES, ns)
    return ns["topologies"](engine, adj, W)


@pytest.fixture(scope="module")
def inputs():
    """The instance's arrays, made by the JAX package (numpy-seeded)."""
    data = js.paper_synthetic(n_nodes=8, n_per_node=30, seed=9)
    adj, _ = jn.random_geometric_graph(8, seed=5)
    f = js.paper_synthetic(n_nodes=8, n_per_node=40, seed=1)
    fadj, _ = jn.random_geometric_graph(8, seed=3)
    return {k: np.array(v) for k, v in dict(
        x=data.x, mask=data.mask, adj=adj,
        W=jn.nearest_neighbor_weights(adj), f_x=f.x, f_mask=f.mask,
        f_adj=fadj, f_W=jn.nearest_neighbor_weights(fadj)).items()}


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, inputs, tmp_path_factory):
    """The ranks' run (started here; `result()` waits)."""
    return launch_ranks(CODE, request.param,
                        tmp_path_factory.mktemp(f"exec{request.param}"),
                        inputs=inputs)


@pytest.fixture(scope="module")
def jax_runs(inputs):
    prior = jx.noninformative_prior(K, D, beta0=0.1, w0_scale=10.0)
    mdl = jm.GMMModel(prior, K, D)
    out = {}
    for name, topo, kw in _topologies(je, jnp.asarray(inputs["adj"]),
                                      jnp.asarray(inputs["W"])):
        out[name] = je.run_vb(mdl, (inputs["x"], inputs["mask"]), topo,
                              n_iters=N_ITERS, **kw)
    fx, fm = inputs["f_x"], inputs["f_mask"]
    out["dist/dsvb"] = ja.run_dsvb(fx, fm, inputs["f_W"], prior, n_iters=40,
                                   K=K, D=D).phi
    out["dist/admm"] = ja.run_dvb_admm(fx, fm, inputs["f_adj"], prior,
                                       n_iters=40, K=K, D=D).phi
    out["dist/ring"] = ja.run_dsvb(
        fx, fm, jn.nearest_neighbor_weights(jn.ring_graph(8)), prior,
        n_iters=40, K=K, D=D).phi
    return out


def _port_model():
    prior = tx.noninformative_prior(K, D, beta0=0.1, w0_scale=10.0,
                                    device="cpu")
    return tm.GMMModel(prior, K, D, device="cpu")


@pytest.fixture(scope="module")
def port_runs(inputs):
    """The port's single-array runs of the same instance."""
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    return {name: te.run_vb(_port_model(), (t["x"], t["mask"]), topo,
                            n_iters=N_ITERS, device="cpu", **kw)
            for name, topo, kw in _topologies(te, t["adj"], t["W"])}


def _close(got, want, rtol=0.0, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=msg)


@pytest.mark.parametrize("name", NAMES)
def test_matches_single_array_executor(ranks, jax_runs, port_runs, name):
    out = ranks.result()
    a = port_runs[name]
    for field in ("phi", "consensus_err", "kl_nodes", "kl_mean"):
        _close(out[f"{name}/{field}"], getattr(a, field),
               atol=EXECUTOR_BAR, msg=field)
    if a.consensus_diag is not None:
        for f, v in a.consensus_diag._asdict().items():
            _close(out[f"{name}/diag/{f}"], v, atol=EXECUTOR_BAR, msg=f)


@pytest.mark.parametrize("name", NAMES)
def test_matches_jax_single_array(ranks, jax_runs, name):
    out = ranks.result()
    a = jax_runs[name]
    phi = np.asarray(a.phi)
    _close(out[f"{name}/phi"], phi, PARITY_RTOL)
    _close(out[f"{name}/kl_mean"], a.kl_mean, PARITY_RTOL)
    _close(out[f"{name}/kl_nodes"], a.kl_nodes, PARITY_RTOL)
    _close(out[f"{name}/consensus_err"], a.consensus_err, PARITY_RTOL,
           atol=1e-24 * float(np.max(phi ** 2)))
    if a.consensus_diag is not None:
        for f in je.ConsensusDiagnostics._fields:
            _close(out[f"{name}/diag/{f}"], getattr(a.consensus_diag, f),
                   PARITY_RTOL, msg=f)


@pytest.mark.parametrize("runner", ["dsvb", "admm", "ring"])
def test_distributed_runners_match_jax(ranks, jax_runs, runner):
    got = ranks.result()[f"dist/{runner}"]
    want = np.asarray(jax_runs[f"dist/{runner}"])
    assert got.shape == want.shape
    assert float(np.max(np.abs(got - want))) < EXECUTOR_BAR


def test_split_run_bit_equal(ranks):
    out = ranks.result()
    n = len([k for k in out if k.startswith("split/whole/")])
    assert n == 14
    for i in range(n):
        np.testing.assert_array_equal(out[f"split/split/{i}"],
                                      out[f"split/whole/{i}"], err_msg=i)


def test_checkpoints_cross_executors(ranks):
    """Saved under one executor, restored into the other: the arrays
    bit-equal to the state saved; continued, within the executor bar of
    the other executor's uninterrupted run."""
    out = ranks.result()
    for i in range(14):
        np.testing.assert_array_equal(out[f"ckpt/into_single/{i}"],
                                      out[f"ckpt/mesh/{i}"], err_msg=i)
        np.testing.assert_array_equal(out[f"ckpt/into_mesh/{i}"],
                                      out[f"ckpt/single/{i}"], err_msg=i)
    assert list(out["ckpt/t"]) == [10, 10]
    whole = out["ckpt/mesh_whole"]
    _close(out["ckpt/mesh_then_single"], whole, atol=EXECUTOR_BAR)
    _close(out["ckpt/single_then_mesh"], whole, atol=EXECUTOR_BAR)


def test_errors(ranks, inputs):
    out = ranks.result()
    assert str(out["err/n_nodes"]).startswith("ValueError: 5 nodes do not "
                                              "split evenly")
    assert str(out["err/backend"]).startswith(
        "ValueError: the mesh executor's group runs gloo for cuda")
    x, mask = (torch.from_numpy(inputs[k]) for k in ("x", "mask"))
    mdl = _port_model()
    with pytest.raises(ValueError, match="metric_nodes"):
        te.vb_init(mdl, (x, mask), te.FusionCenter(), metric_nodes=1,
                   executor=MeshExecutor(), device="cpu")
    with pytest.raises(TypeError, match="MeshExecutor"):
        te.vb_init(mdl, (x, mask), te.Isolated(), executor=object(),
                   device="cpu")
    # this process has no group: the executor raises, nothing falls back
    with pytest.raises(RuntimeError, match="process group"):
        te.run_vb(mdl, (x, mask), te.Isolated(), n_iters=1,
                  executor=MeshExecutor(), device="cpu")
