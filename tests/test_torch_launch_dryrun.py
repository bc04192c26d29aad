"""The allocation-free dry run (`repro_torch.launch.{specs,dryrun}`) on
fake process groups (`dryrun.fake_world`: rank 0 of n, no peers; each
world is destroyed when its test ends).

(b) `arch_variant`, `_batch_axes` and `input_specs` against the
    reference's, leaf for leaf, for every ARCH_ID x INPUT_SHAPES on the
    (16, 16) and (2, 16, 16) production meshes (train in allreduce and
    ADMM): global shapes, dtypes and specs.  The reference's side comes
    from one subprocess with 512 host devices (`jax.eval_shape` and its
    `specs.input_specs`, nothing lowered).  The port holds one tensor a
    layer where the reference stacks a homogeneous model's layers: a
    layer's leaf is the stacked leaf without its layer entry.  The port's
    AdamW count, step and decode position are host ints (the reference's
    are int32 scalars, replicated).
(e) A 2-layer narrow smoke config on a fake (1, 1) world, on meta, gives
    the FLOPs and argument bytes of the real unsharded CPU run of the same
    prefill (with and without the kernels) and allreduce train step
    under FlopCounterMode.
(f) Prefill, decode and all three dp modes dry-run on fake (2, 2) and
    (2, 2, 2) worlds at the smoke configs (Mamba-2 on (2, 2) alone);
    the consensus modes exchange by collective-permutes.
(g) A 4-layer count equals `extrapolate_layers` of the 1- and 2-layer
    counts.
And: `run_one` outside a world of the mesh's size raises, as
`make_production_mesh` does; `--use_kernels` with a train shape raises.
"""
import dataclasses
import json
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard
from torch.utils.flop_counter import FlopCounterMode

from conftest import run_subprocess
from repro.configs import base as jbase
from repro.launch import specs as jspecs
from repro_torch.configs import base as tbase
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_analysis as ha
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs
from repro_torch.models import model as tmodel
from repro_torch.serving import engine as tengine
from repro_torch.training import train_step as tts


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REF_CODE = r"""
import json
import jax
from repro.configs.base import ARCH_IDS, INPUT_SHAPES, get_config
from repro.launch import specs
from repro.launch import mesh as mesh_lib
meshes = {"16x16": mesh_lib.make_production_mesh(),
          "2x16x16": mesh_lib.make_production_mesh(multi_pod=True)}

def key(k):
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return getattr(k, attr)
    raise TypeError(k)

def spec(s):
    return None if s is None else [list(e) if isinstance(e, tuple) else e
                                   for e in s.spec]

out = {}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        for mk, mesh in meshes.items():
            modes = (("allreduce", "admm") if shape.kind == "train"
                     else ("allreduce",))
            for mode in modes:
                axis = None if mode == "allreduce" else (
                    "pod" if "pod" in mesh.axis_names else "data")
                tree = specs.input_specs(cfg, shape, mesh, dp_mode=mode,
                                         consensus_axis=axis)
                out[f"{arch}/{name}/{mk}/{mode}"] = [
                    [[key(k) for k in p], list(l.shape), str(l.dtype),
                     spec(l.sharding)]
                    for p, l in jax.tree_util.tree_flatten_with_path(
                        tree)[0]]
print("JSON" + json.dumps(out))
"""

MESHES = {"16x16": (False, 256), "2x16x16": (True, 512)}


@pytest.fixture(scope="module")
def reference_specs():
    out = run_subprocess(REF_CODE, n_devices=512)
    return json.loads(out.split("JSON", 1)[1])


def _norm(spec, ndim) -> list:
    """A spec as a list of ndim entries: a 1-tuple entry as its axis, an
    empty one as None."""
    out = []
    for e in (spec or []):
        if isinstance(e, list):
            e = None if not e else (e[0] if len(e) == 1 else e)
        out.append(e)
    return out + [None] * (ndim - len(out))


def _spec_of(t: DTensor) -> list:
    """The spec of a DTensor: each dim's mesh axes, in the mesh's order."""
    names = t.device_mesh.mesh_dim_names
    axes = [[] for _ in range(t.ndim)]
    for name, p in zip(names, t.placements):
        if isinstance(p, Shard):
            axes[p.dim].append(name)
    return [None if not a else (a[0] if len(a) == 1 else a) for a in axes]


def _dtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _port_leaves(tree, cfg, replica=None) -> dict:
    """{reference path: (shape, dtype, spec)} of the port's input specs,
    a homogeneous stack's layers mapped onto the stacked leaf (checked
    alike layer by layer); host ints as None.  `replica` (axis, size): a
    consensus state's leaves get the reference's leading replica axis
    (the port holds one replica a rank)."""
    homo = tmodel._homogeneous(cfg)
    out: dict = {}
    lead = ([replica[1]], [replica[0]]) if replica else ([], [])

    def put(path, t):
        if not isinstance(t, torch.Tensor):
            assert isinstance(t, int), (path, t)
            out[path] = None
            return
        if isinstance(t, DTensor):
            assert t.to_local().is_meta, path
            leaf = (list(t.shape), _dtype(t), _spec_of(t))
        else:                           # held whole on every rank (rho)
            assert t.is_meta, path
            leaf = (list(t.shape), _dtype(t), [None] * t.ndim)
        if path in out:
            assert out[path] == leaf, path
        out[path] = leaf

    def named(prefix, named_tensors):
        for name, t in named_tensors.items():
            parts = name.split(".")
            shape, spec = lead[0] + list(t.shape), lead[1] + _spec_of(t)
            if parts[0] == "blocks" and homo:
                path = prefix + ("blocks",) + tuple(parts[2:])
                shape = shape[:len(lead[0])] + [cfg.n_layers] + \
                    shape[len(lead[0]):]
                spec = spec[:len(lead[1])] + [None] + spec[len(lead[1]):]
            elif parts[0] == "blocks":
                path = prefix + ("blocks", int(parts[1])) + tuple(parts[2:])
            else:
                path = prefix + tuple(parts)
            assert isinstance(t, DTensor) and t.to_local().is_meta, path
            leaf = (shape, _dtype(t), spec)
            assert out.setdefault(path, leaf) == leaf, path

    for k, v in tree.items():
        if k == "state":
            named(("state", "params"), dict(v.params.named_parameters()))
            named(("state", "opt", "mu"), v.opt.mu)
            named(("state", "opt", "nu"), v.opt.nu)
            put(("state", "opt", "count"), v.opt.count)
            put(("state", "step"), v.step)
            if v.duals is not None:
                named(("state", "duals"), v.duals)
                put(("state", "rho"), v.rho)
        elif k == "batch":
            for b, t in v.items():
                put(("batch", b), t)
        elif k == "params":
            named(("params",), dict(v.named_parameters()))
        elif k == "cache":
            for i, entry in enumerate(v):
                for j, t in enumerate(entry):
                    if homo:
                        leaf = ([cfg.n_layers] + list(t.shape), _dtype(t),
                                [None] + _spec_of(t))
                        assert out.setdefault(("cache", j), leaf) == leaf
                    else:
                        put(("cache", i, j), t)
        else:
            put((k,), v)
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_input_specs_match_reference(mesh_name, reference_specs):
    multi_pod, world = MESHES[mesh_name]
    n = 0
    with dryrun.fake_world(world):
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                             device="cpu")
        sizes = mesh_lib.axis_sizes(mesh)
        for arch in tbase.ARCH_IDS:
            tcfg, jcfg = tbase.get_config(arch), jbase.get_config(arch)
            for name, shape in tbase.INPUT_SHAPES.items():
                jshape = jbase.INPUT_SHAPES[name]
                assert dataclasses_equal(specs.arch_variant(tcfg, shape),
                                         jspecs.arch_variant(jcfg, jshape))
                assert specs._batch_axes(mesh, shape.global_batch) == \
                    jspecs._batch_axes(_standin(sizes), jshape.global_batch)
                modes = (("allreduce", "admm") if shape.kind == "train"
                         else ("allreduce",))
                for mode in modes:
                    axis = None if mode == "allreduce" else (
                        "pod" if multi_pod else "data")
                    tree = specs.input_specs(tcfg, shape, mesh, dp_mode=mode,
                                             consensus_axis=axis)
                    got = _port_leaves(
                        tree, specs.arch_variant(tcfg, shape),
                        (axis, sizes[axis]) if axis else None)
                    want = {tuple(p): (s, d, sp) for p, s, d, sp in
                            reference_specs[f"{arch}/{name}/{mesh_name}/"
                                            f"{mode}"]}
                    assert set(got) == set(want), (arch, name, mode)
                    for path, leaf in got.items():
                        s, d, sp = want[path]
                        if leaf is None:          # a host int
                            assert s == [] and d == "int32" and \
                                _norm(sp, 0) == [], path
                            continue
                        if path[-1] in ("tokens", "token"):
                            assert d == "int32"
                        assert leaf == (s, d, _norm(sp, len(s))), \
                            (arch, name, mode, path, leaf, want[path])
                        n += 1
    assert n > 1000


def dataclasses_equal(a, b) -> bool:
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def _standin(sizes):
    """The reference's mesh stand-in: axis names and a device array."""
    return types.SimpleNamespace(axis_names=tuple(sizes),
                                 devices=np.empty(tuple(sizes.values()),
                                                  dtype=object))


# ---------------------------------------------------------------------------
# run_one needs a world of the mesh's size
# ---------------------------------------------------------------------------
def test_run_one_outside_a_world_raises():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="ranks"):
        dryrun.run_one("yi_6b", "decode_32k", verbose=False)
    with dryrun.fake_world(4):
        with pytest.raises(ValueError, match="256 ranks"):
            dryrun.run_one("yi_6b", "decode_32k", verbose=False)
        with pytest.raises(RuntimeError, match="process group exists"):
            with dryrun.fake_world(256):
                pass
    assert not dist.is_initialized()


def test_use_kernels_with_a_train_shape_raises():
    with dryrun.fake_world(256):
        with pytest.raises(RuntimeError, match="no backward"):
            dryrun.run_one("yi_6b", "train_4k", use_kernels=True,
                           verbose=False)


# ---------------------------------------------------------------------------
# (e) the dry run against the real unsharded CPU run
# ---------------------------------------------------------------------------
SMALL = tbase.ShapeConfig("small", 64, 4, "prefill")
SMALL_TRAIN = tbase.ShapeConfig("small", 64, 4, "train")


def _small_cfg(arch):
    return tbase.get_smoke_config(arch).replace(n_layers=2)


def _real_inputs(cfg, shape):
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (
        shape.global_batch, shape.seq_len)), dtype=specs.TOKEN_DTYPE)
    return tokens


@pytest.mark.parametrize("arch,kernels", [("yi_6b", False),
                                          ("yi_6b", True),
                                          ("mamba2_370m", True),
                                          ("granite_moe_3b_a800m", False)])
def test_prefill_counts_equal_the_real_cpu_run(arch, kernels):
    cfg = _small_cfg(arch)
    lm = tmodel.LM(cfg, device="cpu")
    tokens = _real_inputs(cfg, SMALL)
    pre = tengine.make_prefill_step(cfg, use_kernels=kernels)
    with torch.no_grad(), FlopCounterMode(display=False) as f:
        pre(lm, tokens)
    want_args = ha.local_bytes((lm, tokens))
    with dryrun.fake_world(1):
        mesh = mesh_lib.make_test_mesh(1, 1, device="cpu")
        fn, inputs = specs.build_step(cfg, SMALL, mesh, use_kernels=kernels)
        c = ha.count(fn, inputs)
    assert c.flops == f.get_total_flops() > 0
    assert c.argument_bytes == want_args
    if kernels:
        kind = "ssd_scan" if arch.startswith("mamba") else "flash_attention"
        assert c.kernel_calls == {kind: 2}


@pytest.mark.parametrize("arch", ["yi_6b", "mamba2_370m"])
def test_train_step_counts_equal_the_real_cpu_run(arch):
    cfg = _small_cfg(arch)
    state = tts.init_state(cfg, device="cpu")
    batch = {"tokens": _real_inputs(cfg, SMALL_TRAIN)}
    want_args = ha.local_bytes((state, batch))
    step = tts.make_train_step(cfg)
    with FlopCounterMode(display=False) as f:
        step(state, batch)
    with dryrun.fake_world(1):
        mesh = mesh_lib.make_test_mesh(1, 1, device="cpu")
        fn, inputs = specs.build_step(cfg, SMALL_TRAIN, mesh)
        c = ha.count(fn, inputs)
    assert c.flops == f.get_total_flops() > 0
    assert c.argument_bytes == want_args


# ---------------------------------------------------------------------------
# (f) every step kind on fake (2, 2) and (2, 2, 2) worlds
# ---------------------------------------------------------------------------
KINDS = [("prefill", "allreduce"), ("decode", "allreduce"),
         ("train", "allreduce"), ("train", "diffusion"), ("train", "admm")]


# Mamba-2 on (2, 2, 2) costs ~2 min of DTensor's redistribution planning
# (a graph search on a 3-D mesh), so it runs on (2, 2) alone
@pytest.mark.parametrize("arch,pod", [
    (arch, pod) for pod in (0, 2)
    for arch in ("yi_6b", "mamba2_370m", "recurrentgemma_2b",
                 "granite_moe_3b_a800m")
    if not (pod and arch == "mamba2_370m")])
def test_every_step_kind_on_small_fake_meshes(arch, pod):
    cfg = _small_cfg(arch)
    with dryrun.fake_world(8 if pod else 4):
        mesh = mesh_lib.make_test_mesh(2, 2, pod=pod, device="cpu")
        for kind, mode in KINDS:
            shape = tbase.ShapeConfig("small", 32 if kind != "decode"
                                      else 48, 8, kind)
            axis = None if mode == "allreduce" else ("pod" if pod
                                                     else "data")
            fn, inputs = specs.build_step(cfg, shape, mesh, dp_mode=mode,
                                          consensus_axis=axis)
            c = ha.count(fn, inputs)
            coll = c.collectives.count_by_kind
            assert c.flops > 0 and c.hbm_bytes > 0, (kind, mode)
            assert c.argument_bytes > 0 and c.temp_bytes > 0, (kind, mode)
            if mode == "allreduce":
                assert "collective-permute" not in coll, (kind, coll)
            else:
                # two ring exchanges a combine (diffusion), more for ADMM
                assert coll.get("collective-permute", 0) >= 2, (mode, coll)
                assert coll.get("all-reduce", 0) >= 1, (mode, coll)


# ---------------------------------------------------------------------------
# (g) the layer extrapolation against a deeper count
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_four_layers_equal_the_extrapolation(kind):
    cfg = tbase.get_smoke_config("yi_6b")
    shape = tbase.ShapeConfig("small", 32, 8, kind)
    with dryrun.fake_world(4):
        mesh = mesh_lib.make_test_mesh(2, 2, device="cpu")
        roofs = {}
        for n in (1, 2, 4):
            fn, inputs = specs.build_step(
                cfg.replace(n_layers=n, scan_layers=False), shape, mesh)
            roofs[n] = ha.analyze(fn, inputs, 4, 1.0)
    ext = ha.extrapolate_layers(roofs[1], roofs[2], 4)
    assert ext.as_dict() == roofs[4].as_dict()


# ---------------------------------------------------------------------------
# F8: the production layouts' faults, on a mesh whose "model" axis does not
# divide the kv heads and whose data axis splits the vocab (fsdp)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,kind", [("yi_6b", "decode"),
                                       ("yi_6b", "prefill"),
                                       ("granite_moe_3b_a800m", "prefill")])
def test_uneven_heads_and_split_vocab_run(arch, kind):
    cfg = _small_cfg(arch)
    assert cfg.n_kv_heads % 4 and cfg.fsdp
    shape = tbase.ShapeConfig("small", 32, 8, kind)
    with dryrun.fake_world(8):
        mesh = mesh_lib.make_test_mesh(2, 4, device="cpu")
        fn, inputs = specs.build_step(cfg, shape, mesh)
        c = ha.count(fn, inputs)
    assert c.flops > 0
