"""The dry run's counting (`repro_torch.launch.hlo_analysis`) and the
kernels' custom ops, against the reference and against known counts.

(a) `Roofline` and `extrapolate_layers` against `repro.launch.
    hlo_analysis` on the reference tests' own numbers: the extrapolation
    exact, the `as_dict` keys equal, each time term the reference's times
    the ratio of the two cards' peaks.
(c) `dryrun.model_flops` and `perf.variant_space` (names, dp modes, the
    overridden configs) equal to the reference's for every ARCH_ID and
    shape.
(d) On a fake (16, 16) world: a product with known placements counts one
    rank's local FLOPs only (DTensor's global-shape propagation is not
    counted); a known redistribution gives its collective's kind, count
    and result bytes; the mesh executor's meta collectives count as
    all-reduce and collective-permute, with no c10d call.
(h) The kernels' custom ops: on CPU tensors the plain version bit for
    bit; on meta the outputs' shapes and the registered FLOP formula
    (`op_count`), with no launch.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import base as jbase
from repro.launch import hlo_analysis as jha
from repro.models import model as jmodel
from repro_torch.configs import base as tbase
from repro_torch.dist import collectives
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as tss
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_analysis as ha
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import perf


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jperf():
    """The reference's perf module; importing it sets XLA_FLAGS (its
    first lines), which is put back at once."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import perf as mod
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod


# ---------------------------------------------------------------------------
# (a) the roofline against the reference
# ---------------------------------------------------------------------------
ROOF = dict(flops=1.97e14, hbm_bytes=819e9 * 2, coll_bytes=50e9 / 2,
            n_chips=256, model_flops=1.97e14 * 128)


def test_roofline_terms_are_the_references_at_h100_peaks():
    r, j = ha.Roofline(**ROOF), jha.Roofline(**ROOF)
    assert r.as_dict().keys() == j.as_dict().keys()
    assert np.isclose(r.t_compute, j.t_compute * jha.PEAK_FLOPS
                      / ha.PEAK_FLOPS, rtol=1e-12)
    assert np.isclose(r.t_memory, j.t_memory * jha.HBM_BW / ha.HBM_BW,
                      rtol=1e-12)
    assert np.isclose(r.t_collective, j.t_collective * jha.ICI_BW
                      / ha.ICI_BW, rtol=1e-12)
    assert r.useful_flops_ratio == j.useful_flops_ratio == 0.5
    # the H100's terms: 1.97e14 / 989e12, 1.638e12 / 3.35e12, 25e9 / 50e9
    assert np.isclose(r.t_compute, 1.97e14 / 989e12)
    assert r.bottleneck == "collective"
    assert (ha.PEAK_FLOPS, ha.HBM_BW, ha.ICI_BW) == (989e12, 3.35e12, 50e9)


@pytest.mark.parametrize("n_layers", [1, 2, 10, 64])
def test_extrapolation_is_the_references_exactly(n_layers):
    kw1 = dict(flops=10.0, hbm_bytes=100.0, coll_bytes=4.0, n_chips=4,
               model_flops=1.0, coll_detail={"all-reduce": 4.0},
               coll_counts={"all-reduce": 2})
    kw2 = dict(flops=16.0, hbm_bytes=150.0, coll_bytes=6.0, n_chips=4,
               model_flops=1.0, coll_detail={"all-reduce": 6.0,
                                             "all-gather": 3.0},
               coll_counts={"all-reduce": 3, "all-gather": 1})
    r = ha.extrapolate_layers(ha.Roofline(**kw1), ha.Roofline(**kw2),
                              n_layers)
    j = jha.extrapolate_layers(jha.Roofline(**kw1), jha.Roofline(**kw2),
                               n_layers)
    assert dataclasses.asdict(r) == dataclasses.asdict(j)
    if n_layers == 10:          # the reference test's own numbers
        assert r.flops == 10 + 9 * 6 and r.hbm_bytes == 100 + 9 * 50
        assert r.coll_counts["all-reduce"] == 2 + 9 * 1


# ---------------------------------------------------------------------------
# (c) model FLOPs and the perf variants against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_model_flops_and_variants_match_reference(arch, jperf):
    tcfg, jcfg = tbase.get_config(arch), jbase.get_config(arch)
    for name, shape in tbase.INPUT_SHAPES.items():
        js = jbase.INPUT_SHAPES[name]
        n_tok = js.global_batch * (js.seq_len if js.kind != "decode" else 1)
        want = ((6.0 if js.kind == "train" else 2.0)
                * jmodel.param_count(jcfg, active_only=True) * n_tok)
        assert dryrun.model_flops(tcfg, shape) == want, name
    got, want = perf.variant_space(tcfg), jperf.variant_space(jcfg)
    assert list(got) == list(want) and len(got) == 23
    for name in got:
        assert got[name]["dp_mode"] == want[name]["dp_mode"], name
        assert dataclasses.asdict(got[name]["cfg"]) == \
            dataclasses.asdict(want[name]["cfg"]), name


# ---------------------------------------------------------------------------
# (d) local FLOPs, collectives and the executor's meta collectives
# ---------------------------------------------------------------------------
def _meta_dtensor(shape, mesh, place):
    local = shape[0] // (16 if isinstance(place[0], Shard) else 1), \
        shape[1] // (16 if isinstance(place[1], Shard) else 1)
    return DTensor.from_local(torch.empty(local, device="meta"), mesh,
                              place, run_check=False,
                              shape=torch.Size(shape), stride=(shape[1], 1))


def test_local_flops_and_collectives_on_a_fake_16x16_world():
    with dryrun.fake_world(256):
        mesh = mesh_lib.make_test_mesh(16, 16, device="cpu")
        a = _meta_dtensor((256, 4096), mesh, (Shard(0), Replicate()))
        w = _meta_dtensor((4096, 4096), mesh, (Replicate(), Shard(1)))
        for _ in range(2):        # DTensor's shape cache cold, then warm
            with ha.Counter() as c:
                y = a @ w
            # one rank's (16, 4096) @ (4096, 256), not the global product
            assert c.flops == 2 * 16 * 4096 * 256
            assert c.collectives.count_by_kind == {}
            assert y.placements == (Shard(0), Shard(1))
        with ha.Counter() as c:
            y.redistribute(mesh, (Shard(0), Replicate()))
        # the "model" axis gathers the columns: (16, 4096) f32 a rank
        assert c.collectives.count_by_kind == {"all-gather": 1}
        assert c.collectives.bytes_by_kind == {"all-gather": 16 * 4096 * 4}
        assert c.flops == 0
        ex = collectives.axis_executor(mesh, "data")
        x = torch.empty((8, 128), dtype=torch.bfloat16, device="meta")
        with ha.Counter() as c:
            s = collectives.psum(x, ex)
            left, right = collectives.ring_neighbors(x, ex)
            m = collectives.pmean(x, ex)
        for t in (s, left, right, m):
            assert t.is_meta and t.shape == x.shape and t.dtype == x.dtype
        assert c.collectives.count_by_kind == {"all-reduce": 2,
                                               "collective-permute": 2}
        assert c.collectives.bytes_by_kind == {
            "all-reduce": 2 * 8 * 128 * 2, "collective-permute": 2 * 8 * 128 * 2}


def test_meta_collectives_have_no_kernel_for_real_tensors():
    with pytest.raises(NotImplementedError):
        torch.ops.repro_torch.meta_all_reduce(torch.zeros(3))
    with pytest.raises(NotImplementedError):
        torch.ops.repro_torch.meta_collective_permute(torch.zeros(3))


def test_counter_tracks_bytes_and_live_memory():
    x = torch.empty((256, 256), device="meta")
    with ha.Counter() as c:
        y = x @ x                      # 2 inputs + 1 output of 256 KiB
        z = y.t()                      # a view: no bytes, no new storage
        del y, z
        w = x + 1
    assert c.flops == 2 * 256 ** 3
    assert c.bytes == 3 * 256 * 256 * 4 + 2 * 256 * 256 * 4
    assert c.peak == 256 * 256 * 4 and c.live == 256 * 256 * 4
    del w


# ---------------------------------------------------------------------------
# (h) the kernels' custom ops
# ---------------------------------------------------------------------------
def _flash_inputs(device, B=2, S=96, Hq=4, Hkv=2, hd=32):
    rng = np.random.default_rng(0)
    return [torch.as_tensor(rng.standard_normal((B, S, h, hd)),
                            dtype=torch.float32).to(device)
            for h in (Hq, Hkv, Hkv)]


def _ssd_inputs(device, B=2, S=128, H=4, P=8, N=8):
    rng = np.random.default_rng(1)
    f = lambda *s: torch.as_tensor(rng.standard_normal(s),
                                   dtype=torch.float32)
    x, Bm, Cm = f(B, S, H, P), f(B, S, N), f(B, S, N)
    dt = torch.as_tensor(rng.uniform(0.01, 0.1, (B, S, H)),
                         dtype=torch.float32)
    A = -torch.as_tensor(rng.uniform(0.5, 1.5, (H,)), dtype=torch.float32)
    return [t.to(device) for t in (x, dt, A, Bm, Cm)]


@pytest.mark.parametrize("window", [0, 17])
def test_flash_custom_op_cpu_bit_equal_and_meta_shapes(window):
    q, k, v = _flash_inputs("cpu")
    before = tfa.flash_attention.launches
    got = ops.flash_attention(q, k, v, window=window)
    assert torch.equal(got, tfa.flash_attention_plain(q, k, v,
                                                      window=window))
    qm, km, vm = _flash_inputs("meta")
    with FlopCounterMode(display=False) as f:
        out = ops.flash_attention(qm, km, vm, window=window)
    assert out.is_meta and out.shape == qm.shape and out.dtype == qm.dtype
    want = tfa.op_count(2, 96, 4, 2, 32, window)[0]
    i = np.arange(96)
    lo = np.maximum(0, i - window + 1) if window else 0
    assert want == 4 * 2 * 4 * 32 * int((i - lo + 1).sum())
    assert f.get_total_flops() == want
    with ha.Counter() as c:
        ops.flash_attention(qm, km, vm, window=window)
    assert c.flops == want and c.kernel_calls == {"flash_attention": 1}
    assert tfa.flash_attention.launches == before     # no real launch


def test_ssd_custom_op_cpu_bit_equal_and_meta_shapes():
    args = _ssd_inputs("cpu")
    before = tss.ssd_scan.launches
    y, h = ops.ssd_scan(*args, chunk=64)
    y2, h2 = tss.ssd_scan_plain(*args, chunk=64)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    margs = _ssd_inputs("meta")
    with FlopCounterMode(display=False) as f:
        ym, hm = ops.ssd_scan(*margs, chunk=64)
    assert ym.is_meta and ym.shape == (2, 128, 4, 8)
    assert hm.shape == (2, 4, 8, 8) and hm.dtype == torch.float32
    L = tss.KERNEL_CHUNK
    tri = L * (L + 1) // 2
    want = 2 * 4 * 2 * 2 * (tri * 8 + tri * 8 + 2 * L * 8 * 8)
    assert f.get_total_flops() == tss.op_count(2, 128, 4, 8, 8)[0] == want
    with ha.Counter() as c:
        ops.ssd_scan(*margs, chunk=64)
    assert c.kernel_calls == {"ssd_scan": 1} and c.flops == want
    assert tss.ssd_scan.launches == before


def test_wrappers_still_validate_before_the_op():
    q, k, v = _flash_inputs("meta")
    with pytest.raises(ValueError):
        ops.flash_attention(q, k[:, :, :1].expand(2, 96, 3, 32), v)
    with pytest.raises(ValueError):
        ops.ssd_scan(*_ssd_inputs("meta", S=100), chunk=64)


def test_process_group_ops_count_as_collectives():
    with dryrun.fake_world(4):
        x = torch.empty((4, 8), device="meta")
        with ha.Counter() as c:
            torch.distributed.all_reduce(x)
            torch.distributed.all_gather_into_tensor(
                torch.empty((16, 8), device="meta"), x)
    assert c.collectives.count_by_kind == {"all-reduce": 1,
                                           "all-gather": 1}
    assert c.collectives.bytes_by_kind == {"all-reduce": 4 * 8 * 4,
                                           "all-gather": 16 * 8 * 4}
