"""repro_torch.core.gmm / backends / blocks / model against the reference.

The reference arithmetic is compared in float64 at rtol 1e-9.  The fused
backend (on the CPU: the kernel's plain version) is compared with the
reference's fused backend (its Pallas kernel in interpret mode) in float32
at rtol 1e-4, on ragged data built as tests/test_backends.py builds it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backends as jb
from repro.core import expfam as jx
from repro.core import gmm as jg
from repro.core import model as jm
from repro.data import synthetic as js
from repro_torch.core import backends as tb
from repro_torch.core import expfam as tx
from repro_torch.core import gmm as tg
from repro_torch.core import model as tm

K, D, N = 3, 2, 6
RTOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _close(got, want, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def f64():
    """Ragged f64 node data and a perturbed per-node iterate stack."""
    d = js.paper_synthetic(n_nodes=N, n_per_node=30, seed=9,
                           unequal_sizes=True, imbalanced=False)
    prior = jx.noninformative_prior(K, D, beta0=0.1, w0_scale=10.0)
    rng = np.random.default_rng(0)
    qs = [prior._replace(m=jnp.asarray(rng.uniform(1, 6, (K, D))),
                         nu=jnp.asarray(rng.uniform(3, 30, K)),
                         alpha=jnp.asarray(rng.uniform(2, 20, K)))
          for _ in range(N)]
    phi = np.stack([np.asarray(jx.pack_natural(q)) for q in qs])
    tprior = tx.GMMPosterior(*(torch.from_numpy(np.asarray(a))
                               for a in prior))
    return d, prior, tprior, phi


def _tpost(phi):
    return tx.unpack_natural(torch.from_numpy(phi), K, D)


def test_vbe_pieces(f64):
    d, prior, tprior, phi = f64
    x, mask = np.asarray(d.x), np.asarray(d.mask)
    tq = _tpost(phi)
    tx_, tmask = torch.from_numpy(x), torch.from_numpy(mask)
    jq = jax.jit(jax.vmap(lambda p: jx.unpack_natural(p, K, D)))(phi)

    r = tg.responsibilities(tx_, tq, tmask)
    _close(r, jax.jit(jax.vmap(jg.responsibilities))(d.x, jq, d.mask))
    for g, w in zip(tg.estep_terms(tq),
                    jax.jit(jax.vmap(jg.estep_terms))(jq)):
        _close(g, w)
    st = tg.sufficient_stats(tx_, r, float(N))
    jst = jax.jit(jax.vmap(
        lambda xi, ri: jg.sufficient_stats(xi, ri, float(N))))(
        d.x, r.numpy())
    for g, w in zip(st, jst):
        _close(g, w)
    post = tg.posterior_from_stats(st, tprior)
    jpost = jax.jit(jax.vmap(lambda s: jg.posterior_from_stats(s, prior)))(
        jg.SuffStats(*(jnp.asarray(a.numpy()) for a in st)))
    for g, w in zip(post, jpost):
        _close(g, w)
    _close(tg.local_vbm_optimum_nodes(tx_, torch.from_numpy(phi), tprior,
                                      float(N), K, D, tmask),
           jax.jit(jg.local_vbm_optimum_nodes, static_argnums=(3, 4, 5))(
               d.x, phi, prior, float(N), K, D, d.mask))
    _close(tg.elbo(tx_[0], tx.GMMPosterior(*(a[0] for a in tq)), tprior,
                   3.0),
           jax.jit(jg.elbo)(d.x[0], jx.GMMPosterior(*(a[0] for a in jq)),
                            prior, 3.0))
    np.testing.assert_array_equal(
        tg.predict_labels(tx_[1], tx.GMMPosterior(*(a[1] for a in tq))),
        jg.predict_labels(d.x[1], jx.GMMPosterior(*(a[1] for a in jq))))


def test_ground_truth_posterior(f64):
    d, prior, tprior, _ = f64
    from repro_torch.data import synthetic as ts
    td = ts.paper_synthetic(n_nodes=N, n_per_node=30, seed=9,
                            unequal_sizes=True, imbalanced=False)
    xa, la = d.flat
    txa, tla = td.flat
    for g, w in zip(tg.ground_truth_posterior(txa, tla, tprior, K),
                    jg.ground_truth_posterior(xa, la, prior, K)):
        _close(g, w)


def test_model_surface(f64):
    """GMMModel pack/unpack/project/kl/local_optimum and the block view."""
    d, prior, tprior, phi = f64
    jmdl = jm.GMMModel(prior, K, D)
    tmdl = tm.GMMModel(tprior, K, D, device="cpu")
    assert tmdl.flat_dim == jmdl.flat_dim
    np.testing.assert_array_equal(tmdl.block_labels(), jmdl.block_labels())
    assert tmdl.BLOCK_NAMES == jmdl.BLOCK_NAMES
    _close(tmdl.init_phi(), jmdl.init_phi())
    tphi = torch.from_numpy(phi)
    _close(tmdl.pack(tmdl.unpack(tphi)), tphi, rtol=1e-9, atol=1e-9)
    _close(tmdl.pack(tx.unpack_natural(tphi, K, D)),
           jax.jit(jax.vmap(lambda p: jmdl.pack(jmdl.unpack(p))))(phi))
    rng = np.random.default_rng(3)
    bad = phi + 20.0 * rng.normal(size=phi.shape)
    want = jax.jit(jax.vmap(jmdl.project_to_domain))(bad)
    for g, w in zip(tmdl.project_to_domain(torch.from_numpy(bad)), want):
        _close(g, w, atol=RTOL * np.abs(np.asarray(w)).max())
    _close(tmdl.kl(tphi[:, None], tphi[None]),
           jax.jit(jax.vmap(jax.vmap(jmdl.kl, (None, 0)), (0, None)))(
               phi, phi),
           atol=1e-9)
    data_t = (torch.from_numpy(np.asarray(d.x)),
              torch.from_numpy(np.asarray(d.mask)))
    _close(tmdl.local_optimum(data_t, tphi, float(N)),
           jax.jit(jmdl.local_optimum)((d.x, d.mask), phi, float(N)))
    # the reference backend object is the same arithmetic, unreplicated
    _close(tb.ReferenceBackend().local_vbm_optimum_nodes(
        *data_t, tphi, tprior, 1.0, K, D),
        jax.jit(lambda x, m, p: jb.ReferenceBackend().local_vbm_optimum_nodes(
            x, m, p, prior, 1.0, K, D))(d.x, d.mask, phi))


def test_fused_backend_f32():
    """Fused (plain kernel) == reference fused (interpret kernel), f32."""
    d = js.paper_synthetic(n_nodes=N, n_per_node=30, seed=9,
                           unequal_sizes=True, imbalanced=False,
                           dtype=np.float32)
    prior = jx.noninformative_prior(K, D, beta0=0.1, w0_scale=10.0,
                                    dtype=jnp.float32)
    rng = np.random.default_rng(1)
    phi = np.stack([np.asarray(jx.pack_natural(prior._replace(
        m=jnp.asarray(rng.uniform(1, 6, (K, D)), jnp.float32))))
        for _ in range(N)]).astype(np.float32)
    tprior = tx.GMMPosterior(*(torch.from_numpy(np.asarray(a))
                               for a in prior))
    args_t = (torch.from_numpy(np.asarray(d.x)),
              torch.from_numpy(np.asarray(d.mask)), torch.from_numpy(phi),
              tprior, float(N), K, D)
    args_j = (d.x, d.mask, jnp.asarray(phi), prior, float(N), K, D)
    got = tb.FusedBackend().local_vbm_optimum_nodes(*args_t)
    assert got.dtype == torch.float32
    want = jb.FusedBackend(block_t=32).local_vbm_optimum_nodes(*args_j)
    _close(got, want, rtol=1e-4, atol=1e-4)
    # and it agrees with the port's own reference backend
    _close(got, tb.ReferenceBackend().local_vbm_optimum_nodes(*args_t),
           rtol=1e-4, atol=1e-4)
    bf16 = tb.FusedBackend(precision=tb.PrecisionPolicy(
        data_dtype=torch.bfloat16))
    jbf16 = jb.FusedBackend(block_t=32, precision=jb.PrecisionPolicy(
        data_dtype=jnp.bfloat16))
    _close(bf16.local_vbm_optimum_nodes(*args_t),
           jbf16.local_vbm_optimum_nodes(*args_j), rtol=1e-4, atol=1e-4)


def test_backend_resolution():
    assert tb.resolve(None).name == "reference"
    assert tb.resolve("fused").name == "fused"
    fb = tb.FusedBackend(block_t=256)
    assert tb.resolve(fb) is fb
    with pytest.raises(ValueError, match="unknown backend"):
        tb.resolve("mosaic")
    with pytest.raises(TypeError):
        tb.resolve(3)
    prior = tx.noninformative_prior(K, D)
    mdl = tm.GMMModel(prior, device="cpu")
    assert fb.supports(mdl) and tb.ReferenceBackend().supports(mdl)
    assert mdl.with_backend("fused").backend.name == "fused"
    # every K x D has a fused kernel (K = 13 at D = 64 was past the first
    # wide kernel's shared memory); a model with no fused kernel does not
    assert fb.supports(tm.GMMModel(tx.noninformative_prior(13, 64),
                                   device="cpu"))
    assert not fb.supports(tm.LinRegModel(D=2, device="cpu"))


@pytest.mark.parametrize("policy", ["f64_data", "bf16"])
def test_fused_backend_casts_data_once_per_session(policy, monkeypatch):
    """engine.vb_init casts the data to the kernel's streaming dtype once:
    every iteration's kernel call receives the same tensor, already in that
    dtype (f32 for f64 data; bf16 under the bf16 policy), and the KL
    trajectory equals a run on data cast beforehand, which is what the
    former per-iteration cast computed."""
    from repro_torch.core import algorithms as ta
    from repro_torch.core import network as tn
    from repro_torch.kernels import ops
    d = js.paper_synthetic(n_nodes=N, n_per_node=40, seed=5,
                           dtype=np.float64)
    x, mask = (torch.tensor(np.asarray(a)) for a in (d.x, d.mask))
    prior = tx.noninformative_prior(K, D, beta0=0.1, w0_scale=10.0,
                                    dtype=torch.float64)
    adj, _ = tn.random_geometric_graph(N, seed=4)
    W = tn.nearest_neighbor_weights(adj).double()
    ref = tx.pack_natural(prior)
    if policy == "bf16":
        backend = tb.FusedBackend(precision=tb.PrecisionPolicy(
            data_dtype=torch.bfloat16))
        x, mask, want = x.float(), mask.float(), torch.bfloat16
    else:
        backend, want = tb.FusedBackend(), torch.float32
    seen = []
    kernel = ops.gmm_estep_nodes

    def spy(xs, ms, *a, **kw):
        seen.append((xs.dtype, ms.dtype, xs.data_ptr(), ms.data_ptr()))
        return kernel(xs, ms, *a, **kw)

    monkeypatch.setattr(ops, "gmm_estep_nodes", spy)
    run = lambda xx, mm: ta.run_dsvb(xx, mm, W, prior, n_iters=6, K=K, D=D,
                                     ref_phi=ref, backend=backend,
                                     device="cpu")
    got = run(x, mask)
    assert len(seen) == 6
    assert {s[:2] for s in seen} == {(want, want)}
    assert len({s[2:] for s in seen}) == 1      # one copy, cast once
    pre = run(x.to(want), mask.to(want))
    assert torch.equal(got.kl_mean, pre.kl_mean)
    assert torch.equal(got.phi, pre.phi)
