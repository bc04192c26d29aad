"""The port's LM sharding on a (2, 2) ("data", "model") mesh of 4 gloo
ranks, held against unsharded runs of the port (which the other
tests/test_torch_lm_*.py files hold against the JAX package).  One
launch of 4 ranks runs every case (`test_torch_mesh_collectives.
launch_ranks`: one torch thread a rank, no jax), on the f32 smoke
configs.

* forward logits of a dense, a MoE (global and local dispatch, a capacity
  that drops tokens), an RG-LRU and a Mamba-2 config, fsdp on, against
  the unsharded forward: 1e-5 relative (local dispatch: against the
  unsharded forward of each data shard's rows, its per-shard capacity);
* `Engine(mesh=)` greedy tokens equal to the unsharded engine's (dense,
  RG-LRU with one kv head, Mamba-2);
* 3 allreduce steps (fsdp on): the loss at 1e-5 and each parameter at
  1e-4 relative L2 error against one process on the global batch; the
  same bars for 2 steps of a MoE (global dispatch, dropping tokens), an
  RG-LRU and a Mamba-2 config;
* every rank's parameters, moments and duals (allreduce, diffusion,
  ADMM, and a state restored on the mesh) are blocks with storage of
  their own size;
* diffusion and ADMM: the same bars against the port's (2, 1) mesh run
  (two (2, 1) meshes of two ranks each in the same world);
* the assertions of the reference's `test_train_modes_on_mesh` (losses
  of the three modes within 0.05, `consensus_residual` < 1e-6), and
  `admm_rho` moving under `adaptive_rho` (fixed without it);
* a `Trainer` checkpoint saved on (2, 2) and read back on (1, 1);
* a (1, 1) mesh bit-equal to no mesh: forward, engine tokens and three
  allreduce steps.
"""
import numpy as np
import pytest

from test_torch_mesh_collectives import launch_ranks

CODE = r'''
import torch
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs.base import ModelConfig, get_smoke_config
from repro_torch.dist import sharding as S
from repro_torch.launch import mesh as ml
from repro_torch.models import model as M
from repro_torch.serving import engine as E
from repro_torch.training import train_step as ts
from repro_torch.training.trainer import Trainer

MESH = ml.make_test_mesh(2, 2, device="cpu")
# every rank builds every rank's (1, 1) mesh and both (2, 1) meshes, in
# the same order, and uses its own
ONE = [DeviceMesh("cpu", torch.tensor([[r]]), mesh_dim_names=("data",
                                                               "model"))
       for r in range(4)][RANK]
PAIR = [DeviceMesh("cpu", torch.tensor([[a], [b]]),
                   mesh_dim_names=("data", "model"))
        for a, b in ((0, 1), (2, 3))][RANK // 2]
B, SEQ = 4, 32
HYPER = ts.TrainHyper(peak_lr=1e-3, warmup=2, total_steps=10)


def rel(a, b):
    return float((a - b).norm() / b.norm())


def forward(cfg, lm, tok, mesh):
    if mesh is None:
        return M.forward(cfg, lm, tok)
    dl = S.distribute_copy(lm, mesh, S.param_shardings(
        dict(lm.named_parameters()), mesh, fsdp=cfg.fsdp,
        scanned=M._homogeneous(cfg),
        no_fsdp_keys=("moe",) if cfg.moe_local_dispatch else ()))
    with S.use_mesh(mesh):
        out = M.forward(cfg, dl, S.to_dtensor(
            tok, mesh, S.placements_for(mesh, batch=tok.shape[0])))
    return {k: S.full(v) for k, v in out.items()}


FWD = {"dense": get_smoke_config("yi_6b"),
       "moe": get_smoke_config("granite_moe_3b_a800m").replace(
           capacity_factor=0.5),
       "moe_local": get_smoke_config("granite_moe_3b_a800m").replace(
           capacity_factor=0.5, moe_local_dispatch=True),
       "rglru": get_smoke_config("recurrentgemma_2b"),
       "mamba2": get_smoke_config("mamba2_370m")}
tok = torch.randint(0, 512, (B, SEQ),
                    generator=torch.Generator().manual_seed(0))
with torch.no_grad():
    for name, cfg in FWD.items():
        lm = M.LM(cfg, device="cpu")
        if cfg.moe_local_dispatch:      # each data shard's own dispatch
            parts = [M.forward(cfg, lm, tok[i * 2:(i + 1) * 2])
                     for i in range(2)]
            want = torch.cat([p["logits"] for p in parts])
            want_aux = (parts[0]["aux_loss"] + parts[1]["aux_loss"]) / 2
        else:
            w = M.forward(cfg, lm, tok)
            want, want_aux = w["logits"], w["aux_loss"]
        got = forward(cfg, lm, tok, MESH)
        put(f"fwd/{name}/err", rel(got["logits"], want))
        put(f"fwd/{name}/aux", [float(got["aux_loss"]), float(want_aux)])
        one = forward(cfg, lm, tok, ONE)
        plain = M.forward(cfg, lm, tok)
        put(f"one/fwd/{name}", torch.equal(one["logits"], plain["logits"])
            and float(one["aux_loss"]) == float(plain["aux_loss"]))

rng = np.random.default_rng(0)
for name in ("yi_6b", "recurrentgemma_2b", "mamba2_370m"):
    cfg = get_smoke_config(name)
    lm = M.LM(cfg, device="cpu")
    reqs = [E.Request(rng.integers(0, 512, 32 - 4 * (i % 2)).astype(
        np.int32), 6) for i in range(4)]
    want = E.Engine(cfg, lm, max_seq=48, device="cpu").generate(reqs)
    got = E.Engine(cfg, lm, max_seq=48, device="cpu",
                   mesh=MESH).generate(reqs)
    one = E.Engine(cfg, lm, max_seq=48, device="cpu",
                   mesh=ONE).generate(reqs)
    put(f"engine/{name}", all(np.array_equal(a, b)
                              for a, b in zip(got, want)))
    put(f"one/engine/{name}", all(np.array_equal(a, b)
                                  for a, b in zip(one, want)))


def train(cfg, mesh, mode, steps=3, hyper=HYPER, tokens=None):
    """(losses, {name: full parameter}, rhos) after `steps` steps."""
    kw = dict(dp_mode=mode, hyper=hyper, global_batch=4, seq_len=SEQ,
              device="cpu")
    tr = Trainer(cfg, mesh, **kw)
    losses, rhos = [], []
    for i in range(steps):
        batch = (tr.next_batch() if tokens is None
                 else {"tokens": tokens})
        tr.state, m = tr.step_fn(tr.state, batch)
        losses.append(float(m["loss"]))
        if tr.state.rho is not None:
            rhos.append(float(tr.state.rho))
    params = {n: S.full(p).detach().clone()
              for n, p in tr.state.params.named_parameters()}
    return losses, params, rhos, m, tr


def own_blocks(tensors):
    """(every DTensor's local block owns storage of its own size, the
    number of blocks smaller than their whole tensor)."""
    own, split = True, 0
    for t in tensors:
        loc = t.to_local()
        own &= loc.untyped_storage().nbytes() == \
            loc.numel() * loc.element_size()
        split += loc.numel() < t.numel()
    return own, split


def state_blocks(tr):
    st = tr.state
    return own_blocks(list(st.params.parameters()) + list(st.opt.mu.values())
                      + list(st.opt.nu.values())
                      + list((st.duals or {}).values()))


cfg = get_smoke_config("yi_6b")
want_l, want_p, _, _, _ = train(cfg, None, "allreduce")
got_l, got_p, _, _, tr22 = train(cfg, MESH, "allreduce")
put("train/allreduce/loss", [got_l, want_l])
put("train/allreduce/perr", max(rel(got_p[n], want_p[n]) for n in want_p))
put("rank/mem/allreduce", state_blocks(tr22))
one_l, one_p, _, _, _ = train(cfg, ONE, "allreduce")
put("one/train/allreduce", one_l == want_l and all(
    torch.equal(one_p[n], want_p[n]) for n in want_p))
# a step of the other families' backward through their per-shard regions
FAMILIES = {"moe": get_smoke_config("granite_moe_3b_a800m").replace(
                capacity_factor=0.5),
            "rglru": get_smoke_config("recurrentgemma_2b"),
            "mamba2": get_smoke_config("mamba2_370m")}
for name, fcfg in FAMILIES.items():     # two steps: the first's lr is 0
    want_l, want_p, _, want_m, _ = train(fcfg, None, "allreduce", steps=2)
    got_l, got_p, _, got_m, _ = train(fcfg, MESH, "allreduce", steps=2)
    put(f"train/{name}/loss", [got_l, want_l])
    put(f"train/{name}/gnorm", [float(got_m["grad_norm"]),
                                float(want_m["grad_norm"])])
    put(f"train/{name}/perr", max(rel(got_p[n], want_p[n])
                                  for n in want_p))
for mode in ("diffusion", "admm"):
    l22, p22, _, _, tr = train(cfg, MESH, mode)
    put(f"rank/mem/{mode}", state_blocks(tr))
    l21, p21, _, _, _ = train(cfg, PAIR, mode)
    put(f"train/{mode}/loss", [l22, l21])
    for n, t in p22.items():          # replica RANK // 2 on (2, 2)
        put(f"rank/{mode}/p22/{n}", t)
        put(f"rank/{mode}/p21/{n}", p21[n])   # replica RANK % 2 on (2, 1)

# the reference's test_train_modes_on_mesh, on the (2, 2) mesh
tiny = ModelConfig(name="tiny", arch_type="dense", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
                   param_dtype="float32", compute_dtype="float32")
toks = torch.randint(0, 128, (8, 32),
                     generator=torch.Generator().manual_seed(1))
red = {}
for mode in ("allreduce", "diffusion", "admm"):
    l, _, _, m, _ = train(tiny, MESH, mode, tokens=toks,
                          hyper=ts.TrainHyper())
    red[mode] = l[-1]
    if mode != "allreduce":
        put(f"rank/red/{mode}/consensus_residual",
            float(m["consensus_residual"]))
put("red/losses", [red["allreduce"], red["diffusion"], red["admm"]])
_, _, rhos, m, _ = train(tiny, MESH, "admm", steps=4, tokens=toks,
                         hyper=ts.TrainHyper(adaptive_rho=True, rho_mu=0.5,
                                             rho=0.5))
put("rho/adaptive", rhos)
put("rho/reported", float(m["admm_rho"]))
_, _, rhos, _, _ = train(tiny, MESH, "admm", steps=3, tokens=toks,
                         hyper=ts.TrainHyper(rho=0.7))
put("rho/fixed", rhos)

# a checkpoint of the (2, 2) allreduce trainer, read back on (1, 1)
ckdir = os.path.join(os.path.dirname(os.environ["MESH_OUT"]), "ckpt")
tr22.ckpt_dir = ckdir
path = tr22.save(3)
put("rank/ckpt_writer", path is not None)
back = Trainer(cfg, ONE, hyper=HYPER, global_batch=4, seq_len=SEQ,
               device="cpu", seed=1, ckpt_dir=ckdir)
back.restore(3)
same = all(torch.equal(S.full(a).detach(), S.full(b).detach())
           for a, b in zip(tr22.state.params.parameters(),
                           back.state.params.parameters()))
same &= all(torch.equal(S.full(tr22.state.opt.nu[k]),
                        S.full(back.state.opt.nu[k]))
            for k in back.state.opt.nu)
put("ckpt/restored_equal", same and back.state.step == 3
    and back.state.opt.count == 3)
# and back on (2, 2): each rank reads its blocks
back22 = Trainer(cfg, MESH, hyper=HYPER, global_batch=4, seq_len=SEQ,
                 device="cpu", seed=1, ckpt_dir=ckdir)
back22.restore(3)
put("rank/ckpt/restored_22", all(
    torch.equal(a.to_local(), b.to_local()) for a, b in zip(
        list(tr22.state.params.parameters())
        + list(tr22.state.opt.mu.values()),
        list(back22.state.params.parameters())
        + list(back22.state.opt.mu.values()))))
put("rank/mem/restored", state_blocks(back22))
'''


@pytest.fixture(scope="module")
def got(tmp_path_factory):
    work = tmp_path_factory.mktemp("lm_sharding_mesh")
    return launch_ranks(CODE, 4, work / "ranks", timeout=300).result()


@pytest.mark.parametrize("name", ["dense", "moe", "moe_local", "rglru",
                                  "mamba2"])
def test_forward_matches_unsharded(got, name):
    assert float(got[f"fwd/{name}/err"]) <= 1e-5
    aux, want = got[f"fwd/{name}/aux"]
    assert aux == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("name", ["yi_6b", "recurrentgemma_2b",
                                  "mamba2_370m"])
def test_engine_tokens_match_unsharded(got, name):
    assert bool(got[f"engine/{name}"])


def test_allreduce_fsdp_matches_one_process(got):
    got_l, want_l = got["train/allreduce/loss"]
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    assert float(got["train/allreduce/perr"]) <= 1e-4


@pytest.mark.parametrize("name", ["moe", "rglru", "mamba2"])
def test_allreduce_families_match_one_process(got, name):
    """Two fsdp steps of the MoE (global dispatch, dropping tokens),
    RG-LRU and Mamba-2 smoke configs: their backward runs through the
    per-shard regions (routing, scans, convolutions)."""
    got_l, want_l = got[f"train/{name}/loss"]
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    gnorm, want = got[f"train/{name}/gnorm"]
    assert gnorm == pytest.approx(want, rel=1e-5)
    assert float(got[f"train/{name}/perr"]) <= 1e-4


@pytest.mark.parametrize("case", ["allreduce", "diffusion", "admm",
                                  "restored"])
def test_ranks_hold_their_blocks_only(got, case):
    """Parameters, moments and duals split by the layout are blocks with
    storage of their own size on every rank: no rank keeps a whole
    tensor alive behind a view."""
    for r in got["ranks"]:
        own, split = r[f"rank/mem/{case}"]
        assert bool(own)
        assert int(split) > 0


@pytest.mark.parametrize("mode", ["diffusion", "admm"])
def test_consensus_matches_two_replica_mesh(got, mode):
    l22, l21 = got[f"train/{mode}/loss"]
    np.testing.assert_allclose(l22, l21, rtol=1e-5)
    ranks = got["ranks"]
    for r in range(4):
        mine, ref = ranks[r], ranks[r // 2]   # rank r//2 holds replica r//2
        names = [k[len(f"rank/{mode}/p22/"):] for k in mine
                 if k.startswith(f"rank/{mode}/p22/")]
        assert names
        for n in names:
            a = mine[f"rank/{mode}/p22/{n}"].astype(np.float64)
            b = ref[f"rank/{mode}/p21/{n}"].astype(np.float64)
            assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b), (r, n)


def test_reference_train_modes_assertions(got):
    """The reference's own test_train_modes_on_mesh assertions."""
    allreduce, diffusion, admm = got["red/losses"]
    assert abs(allreduce - diffusion) < 0.05
    assert abs(allreduce - admm) < 0.05
    for mode in ("diffusion", "admm"):
        for r in got["ranks"]:
            assert float(r[f"rank/red/{mode}/consensus_residual"]) < 1e-6


def test_adaptive_rho_moves(got):
    rhos = list(got["rho/adaptive"])
    assert any(r != 0.5 for r in rhos), rhos
    assert float(got["rho/reported"]) == rhos[-1]
    assert list(got["rho/fixed"]) == [pytest.approx(0.7)] * 3


def test_checkpoint_round_trips_across_meshes(got):
    assert bool(got["ckpt/restored_equal"])
    assert all(bool(r["rank/ckpt/restored_22"]) for r in got["ranks"])
    writers = [bool(r["rank/ckpt_writer"]) for r in got["ranks"]]
    assert writers == [True, False, False, False]


@pytest.mark.parametrize("case", ["fwd/dense", "fwd/moe", "fwd/moe_local",
                                  "fwd/rglru", "fwd/mamba2",
                                  "engine/yi_6b", "engine/recurrentgemma_2b",
                                  "engine/mamba2_370m", "train/allreduce"])
def test_one_by_one_mesh_bit_equal_no_mesh(got, case):
    assert bool(got[f"one/{case}"])
