"""Each check catches the faults its cell can have.  A run on the CPU
(the harness's look for a card skipped) of every cell, cut to a test's
size, with the timed path broken underneath, comes out `correct: false`:
a step that returns its state unchanged; half of each node's points left
out, the statistics taken over the rest; the exchange between nodes left
out; an answer altered where it is produced, at every node or at a
contiguous block of a tenth of them (an indexing fault above some node,
which the median node does not see)."""
from __future__ import annotations

import pytest

from conftest import run_line

CELLS = ("k3d2_100k.dsvb", "k3d2_1k.fleet64_dsvb", "k3d2_100k.admm")


def _unchanged(mp):
    from repro_torch.core import engine

    def frozen(ses, phi, carry, st, t, hyper=None, **kw):
        return phi, carry, st, None

    def fleet_frozen(session, **kw):
        def fn(data, stream_data, phi, carry, st, t, hyper, may_redraw=True):
            return phi, carry, st, None
        return fn

    mp.setattr(engine, "_iteration", frozen)
    mp.setattr(engine, "fleet_step_fn", fleet_frozen)


def _half_batch(mp):
    from repro_torch.core import backends
    orig = backends.FusedBackend.local_vbm_optimum_nodes

    def half(self, x, mask, phi, prior, replication, K, D):
        h = x.shape[1] // 2
        return orig(self, x[:, :h].contiguous(), mask[:, :h].contiguous(),
                    phi, prior, 2.0 * replication, K, D)

    mp.setattr(backends.FusedBackend, "local_vbm_optimum_nodes", half)


def _no_exchange(mp):
    from repro_torch.core import engine

    def isolated(self, varphi, **kw):
        return varphi

    def lonely(self, phi, t, axis=None, local=None):
        deg = phi.new_zeros(phi.shape[-2])
        return deg, (lambda z: torch_zeros(z)), phi.new_ones(())

    mp.setattr(engine.Diffusion, "combine", isolated)
    mp.setattr(engine.ADMMConsensus, "_graph_ops", lonely)


def torch_zeros(z):
    import torch
    return torch.zeros_like(z)


def _alter(phi, share):
    """phi with its last `share` of the nodes (axis -2) scaled by
    1 + 1e-4."""
    lo = phi.shape[-2] - int(share * phi.shape[-2])
    out = phi.clone()
    out[..., lo:, :] *= 1.0 + 1e-4
    return out


def _altered_nodes(mp, share):
    from repro_torch.core import engine
    from repro_torch.serving import driver
    vb_run, evict = engine.vb_run, driver.FleetGroup.evict

    def run_altered(state, n_iters):
        state, run = vb_run(state, n_iters)
        return state.replace(phi=_alter(state.phi, share)), run

    def evict_altered(self, slot):
        rec = evict(self, slot)
        rec["phi"] = _alter(rec["phi"], share)
        return rec

    mp.setattr(engine, "vb_run", run_altered)
    mp.setattr(driver.FleetGroup, "evict", evict_altered)


def _altered(mp):
    _altered_nodes(mp, 1.0)


def _altered_block(mp):
    _altered_nodes(mp, 0.1)


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "no_exchange": _no_exchange, "altered": _altered,
          "altered_block": _altered_block}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_fault_reads_not_correct(small_root, capsys, monkeypatch, workload,
                                 fault):
    FAULTS[fault](monkeypatch)
    rc, line, err = run_line(small_root, capsys, workload)
    assert rc == 0, err
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_reads_correct(small_root, capsys, workload):
    rc, line, err = run_line(small_root, capsys, workload)
    assert rc == 0, err
    assert line["correct"] is True, line["checks"]
