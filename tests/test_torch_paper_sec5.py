"""The port's Sec. V experiments (repro_torch.experiments) against
benchmarks/paper_figures.py, the dataset surrogates against
repro.data.datasets, and the committed reference draws against JAX.

* The surrogates are numpy-seeded: the arrays are exactly equal.
* reference_draws.npz holds `jax.random.uniform(PRNGKey(seed), (K, D),
  float64)` for every (K, D) the figures use; regenerated here with JAX,
  exactly equal.
* Each figure function runs in both packages at a cut iteration count
  (every estimator run capped at CAP iterations; the reference through a
  capped `algorithms` namespace, the port through `max_iters`), reference
  backend, float64, the same draws: the derived strings are equal.  The
  reference's snapshot files are redirected to memory (nothing is written
  under experiments/).  fig13_coil20's case is in
  test_torch_paper_sec5_fig13.py, with this module's fixtures, so the two
  long cases run on different workers.
"""
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import algorithms as ja
from repro.data import datasets as jd
from repro_torch.data import datasets as td
from repro_torch.experiments import common as tcommon
from repro_torch.experiments import paper_figures as tpf

REPO = Path(__file__).resolve().parent.parent
CAP = 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch intra-op thread: under the suite's six workers the
    default pool (a thread per core in each worker) oversubscribes the
    cores, and these small ops spend most of their time synchronising
    the pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def jfigs():
    """benchmarks.paper_figures with in-memory snapshots and every run
    capped at CAP iterations."""
    sys.path.insert(0, str(REPO))
    try:
        from benchmarks import common as jcommon
        from benchmarks import paper_figures as jpf
    finally:
        sys.path.remove(str(REPO))
    store = {}
    saved = (jcommon.save, jcommon.load, jpf.algorithms)

    def capped(fn):
        return lambda *a, n_iters, **k: fn(*a, n_iters=min(n_iters, CAP),
                                           **k)

    jcommon.save = lambda name, payload: store.__setitem__(name, payload)
    jcommon.load = store.get
    jpf.algorithms = types.SimpleNamespace(**{
        n: capped(getattr(ja, n)) for n in ("run_cvb", "run_noncoop",
                                             "run_nsg_dvb", "run_dsvb",
                                             "run_dvb_admm")})
    yield jpf, store
    jcommon.save, jcommon.load, jpf.algorithms = saved


@pytest.mark.parametrize("name,args", [
    ("atmosphere_surrogate", dict(n_nodes=20, seed=0)),
    ("atmosphere_surrogate", dict(n_nodes=7, seed=3)),
    ("ionosphere_surrogate", dict(n_nodes=20, seed=0)),
    ("coil20_surrogate", dict(n_classes=2, n_nodes=10, seed=2)),
    ("coil20_surrogate", dict(n_classes=6, n_nodes=10, seed=6)),
    ("coil20_surrogate", dict(n_classes=10, n_nodes=10, seed=10)),
])
def test_datasets_equal_reference(name, args):
    got, want = getattr(td, name)(**args), getattr(jd, name)(**args)
    for g, w in zip(got, want):
        w = np.array(w)
        assert g.dtype == torch.from_numpy(w).dtype
        np.testing.assert_array_equal(g.numpy(), w)


def test_reference_draws_equal_jax():
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import torch_reference_draws
    finally:
        sys.path.remove(str(REPO / "tools"))
    want = torch_reference_draws.draws()
    for (seed, K, D) in torch_reference_draws.SHAPES:
        got = tcommon.reference_draws(seed, K, D)
        w = want[tcommon.draw_key(seed, K, D)]
        assert got.dtype == np.float64 and got.shape == (K, D)
        np.testing.assert_array_equal(got, w)
    with pytest.raises(KeyError, match="torch_reference_draws"):
        tcommon.reference_draws(0, 7, 7)


# fig13_coil20 (the longest, ~280 s) runs in test_torch_paper_sec5_fig13.py
# on its own worker
@pytest.mark.parametrize("fig", [f.__name__ for f in tpf.ALL
                                 if f.__name__ != "fig13_coil20"])
def test_figure_matches_reference(jfigs, fig):
    check_figure(jfigs, fig)


def check_figure(jfigs, fig):
    """The figure's derived strings, both packages, every run capped."""
    jpf, store = jfigs
    store.clear()
    want = getattr(jpf, fig)(False)
    got = getattr(tpf, fig)(False, backend="reference", device="cpu",
                            max_iters=CAP)
    assert [r[0] for r in got] == [r[0] for r in want]
    assert [r[2] for r in got] == [r[2] for r in want]


def test_fig4_takes_fig3s_tau():
    """fig4 runs dSVB at the tau fig3 stored in the caller's `results`,
    else 0.05 (the reference reads it from fig3's snapshot)."""
    kw = dict(device="cpu", backend="reference", max_iters=2)
    assert tpf.fig4_convergence(**kw)[0][2].endswith("tau=0.05")
    results = {}
    tpf.fig3_tau_sweep(results=results, **kw)
    tau = results["fig3_tau_sweep"]["best_tau"]
    results["fig3_tau_sweep"]["best_tau"] = 0.3
    assert tpf.fig4_convergence(results=results, **kw)[0][2].endswith(
        "tau=0.3")
    assert tau in (0.02, 0.05, 0.1, 0.2, 0.3, 0.5, 0.8)
    assert set(results) == {"fig3_tau_sweep", "fig4_convergence"}


def test_accuracy_is_best_permutation():
    """The accuracy of a node is its best label permutation's."""
    data = td.atmosphere_surrogate(n_nodes=4, seed=0)
    from repro_torch.core import expfam, gmm
    prior = expfam.noninformative_prior(2, 3, beta0=0.05, w0_scale=5.0)
    x_all, lab = data.flat
    q = gmm.ground_truth_posterior(x_all, lab, prior, 2)
    phi = expfam.pack_natural(q)
    swapped = expfam.pack_natural(expfam.GMMPosterior(
        *(a.flip(0) for a in q)))
    acc = tcommon.accuracy(data, torch.stack([phi, swapped]), 2, 3)
    assert acc == 1.0


def test_cli_runs_on_the_cpu(capsys):
    tpf.main(["--device", "cpu", "--backend", "fused", "--max-iters", "2",
              "--only", "table2_ionosphere"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert out[1].startswith("table2_ionosphere,") and "acc cvb=" in out[1]
