"""The port's LM partitioning specs against the reference's, leaf for leaf,
at published width, without ranks or allocations.

* `param_shardings` and `train_step.state_shardings` (all three dp modes,
  fsdp on and off, `moe_local_dispatch` on and off) for every ARCH_ID on
  the (1, 1), (4, 2), (16, 16) and (2, 16, 16) meshes: the reference's
  shapes come from `jax.eval_shape` of its `init_params` / `init_state`,
  its specs from its own functions on a stand-in mesh (`axis_names` and
  `devices.shape`; `NamedSharding` replaced by the bare spec, since the
  stand-in has no devices); the port's from its parameters on the meta
  device.  The port holds one tensor a layer and one replica a rank, so
  its spec is the reference's with the layer (scan) and replica entries
  dropped, and those entries must be None and the consensus axis.
* `serving.engine.cache_shardings` and `dist.sharding.batch_spec`, which
  need a real `jax.sharding.Mesh`: one subprocess with 8 host devices
  prints the reference's specs as JSON, on the (1, 1), (4, 2), (8, 1) and
  (2, 2, 2) meshes, for the decode_32k and long_500k cache shapes.
* `spec_for` on the reference's own rule cases.
"""
import functools
import json
import types

import jax
import numpy as np
import pytest

from conftest import run_subprocess
from repro.configs import base as jbase
from repro.dist import sharding as jsharding
from repro.models import model as jmodel
from repro.training import train_step as jts
from repro_torch.configs import base as tbase
from repro_torch.dist import sharding as tsharding
from repro_torch.models import model as tmodel
from repro_torch.serving import engine as tengine
from repro_torch.training import train_step as tts

MESHES = {"1x1": (("data", "model"), (1, 1)),
          "4x2": (("data", "model"), (4, 2)),
          "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def standin(names, shape):
    """Anything with the mesh's axis names and device-array shape."""
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=object))


@pytest.fixture
def bare_specs(monkeypatch):
    """The reference's sharding functions return bare PartitionSpecs."""
    for mod in (jsharding, jts):
        monkeypatch.setattr(mod, "NamedSharding", lambda mesh, spec: spec)


def ref_specs(tree) -> dict:
    """{path: spec tuple} of a reference tree of PartitionSpecs."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(_key(k) for k in p): tuple(s) for p, s in leaves}


def _key(k):
    """A path entry's dict key, sequence index or attribute name."""
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return getattr(k, attr)
    raise TypeError(k)


def ref_path(name: str, homogeneous: bool) -> tuple:
    """The reference leaf of a port parameter name (blocks.3.attn.wq ->
    ('blocks', 'attn', 'wq') stacked, ('blocks', 3, 'attn', 'wq') not)."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return tuple(parts)
    if homogeneous:
        return ("blocks",) + tuple(parts[2:])
    return ("blocks", int(parts[1])) + tuple(parts[2:])


def check_tree(port: dict, ref: dict, prefix: tuple, cfg, replica) -> int:
    """Every port leaf's spec equals its reference leaf's, with the
    replica and layer entries dropped (and those entries checked)."""
    homo = tmodel._homogeneous(cfg)
    seen = set()
    for name, spec in port.items():
        path = prefix + ref_path(name, homo)
        want = ref[path]
        seen.add(path)
        drop = 0
        if replica is not None:
            assert want[0] == replica, (name, want)
            drop = 1
        if homo and name.startswith("blocks."):
            assert want[drop] is None, (name, want)     # the scan axis
            drop += 1
        assert spec == want[drop:], (name, spec, want)
    assert seen == {p for p in ref if p[:len(prefix)] == prefix}
    return len(port)


@functools.lru_cache(maxsize=None)
def ref_shapes(arch: str, mode: str, reps: int):
    """The reference's parameter tree (mode None) or training state at
    published width, as `jax.eval_shape` gives it (nothing allocated;
    the shapes do not depend on fsdp or the dispatch flag)."""
    cfg = jbase.get_config(arch)
    if mode is None:
        return jax.eval_shape(lambda: jmodel.init_params(
            cfg, jax.random.PRNGKey(0)))
    return jax.eval_shape(lambda: jts.init_state(
        cfg, jax.random.PRNGKey(0), dp_mode=mode, n_replicas=reps))


@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_param_and_state_specs_match_reference(arch, bare_specs):
    named = dict(tmodel.LM(tbase.get_config(arch), device="meta",
                           init=False).named_parameters())
    n = 0
    for local in (False, True):
        for fsdp in (True, False):
            jcfg = jbase.get_config(arch).replace(
                fsdp=fsdp, moe_local_dispatch=local)
            tcfg = tbase.get_config(arch).replace(
                fsdp=fsdp, moe_local_dispatch=local)
            for names, shape in MESHES.values():
                mesh = standin(names, shape)
                sizes = dict(zip(names, shape))
                # param_shardings itself, as the serving engine calls it
                ref = ref_specs(jsharding.param_shardings(
                    ref_shapes(arch, None, 1), mesh, fsdp=fsdp,
                    scanned=jmodel._homogeneous(jcfg)))
                n += check_tree(tsharding.param_shardings(
                    named, sizes, fsdp=fsdp,
                    scanned=tmodel._homogeneous(tcfg)), ref, (), tcfg, None)
                for mode in ("allreduce", "diffusion", "admm"):
                    axis = ("pod" if "pod" in names else "data") \
                        if mode != "allreduce" else None
                    reps = sizes.get(axis, 1) if axis else 1
                    ref = ref_specs(jts.state_shardings(
                        ref_shapes(arch, mode, reps), jcfg, mesh,
                        dp_mode=mode, consensus_axis=axis))
                    port_state = tts.TrainState(
                        params=named,
                        opt=tts.adamw.AdamState(mu=named, nu=named, count=0),
                        duals=named if mode == "admm" else None, step=0,
                        rho=0.5 if mode == "admm" else None)
                    got = tts.state_shardings(port_state, tcfg, sizes,
                                              dp_mode=mode,
                                              consensus_axis=axis)
                    for field in ("params", "duals"):
                        tree = getattr(got, field)
                        if tree is not None:
                            n += check_tree(tree, ref, (field,), tcfg, axis)
                    for field in ("mu", "nu"):
                        n += check_tree(getattr(got.opt, field), ref,
                                        ("opt", field), tcfg, axis)
                    assert ref[("opt", "count")] == got.opt.count == ()
                    assert ref[("step",)] == got.step == ()
                    if mode == "admm":
                        assert ref[("rho",)] == got.rho == ()
    assert n > 0


CACHE_CODE = r"""
import json
import jax
from repro.configs.base import ARCH_IDS, get_config
from repro.dist import sharding
from repro.launch import mesh as mesh_lib
from repro.models import model as model_lib
from repro.serving import engine
meshes = {"1x1": mesh_lib.make_test_mesh(1, 1),
          "4x2": mesh_lib.make_test_mesh(4, 2),
          "8x1": mesh_lib.make_test_mesh(8, 1),
          "2x2x2": mesh_lib.make_test_mesh(2, 2, pod=2)}
spec = lambda s: [list(e) if isinstance(e, tuple) else e for e in s]
out = {"batch": {k: spec(sharding.batch_spec(m)) for k, m in meshes.items()}}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    for b, s in ((128, 32768), (1, 524288)):
        cache = jax.eval_shape(lambda: model_lib.init_cache(cfg, b, s))
        for k, m in meshes.items():
            shd = engine.cache_shardings(cache, cfg, m)
            out[f"{arch}/{b}/{k}"] = [spec(x.spec) for x in
                                      jax.tree_util.tree_leaves(shd)]
print("JSON" + json.dumps(out))
"""

CACHE_MESHES = {"1x1": {"data": 1, "model": 1},
                "4x2": {"data": 4, "model": 2},
                "8x1": {"data": 8, "model": 1},
                "2x2x2": {"pod": 2, "data": 2, "model": 2}}


@pytest.fixture(scope="module")
def reference_cache_specs():
    out = run_subprocess(CACHE_CODE, n_devices=8)
    return json.loads(out.split("JSON", 1)[1])


def _json(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def test_batch_spec_matches_reference(reference_cache_specs):
    for k, sizes in CACHE_MESHES.items():
        assert _json(tsharding.batch_spec(sizes)) == \
            reference_cache_specs["batch"][k], k


@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_cache_specs_match_reference(arch, reference_cache_specs):
    cfg = tbase.get_config(arch)
    homo = tmodel._homogeneous(cfg)
    for b, s in ((128, 32768), (1, 524288)):
        cache = tmodel.init_cache(cfg, b, s, device="meta")
        for k, sizes in CACHE_MESHES.items():
            got = tengine.cache_shardings(cache, cfg, sizes)
            want = reference_cache_specs[f"{arch}/{b}/{k}"]
            if homo:    # one stacked leaf a cache field; the layer entry
                assert all(w[0] is None for w in want)
                for entry in got:
                    assert [_json(sp) for sp in entry] == \
                        [w[1:] for w in want], (k, b)
            else:
                assert [_json(sp) for entry in got for sp in entry] == \
                    want, (k, b)


def test_spec_for_rules_and_standin_mesh():
    """The reference's test_sharding_rules cases on the port, and the
    reference's spec_for on a stand-in mesh equal to the port's."""
    sizes = {"data": 4, "model": 2}
    s = tsharding.spec_for((64, 32), sizes, fsdp=True)
    assert "model" in s and "data" in s, s
    assert tsharding.spec_for((7, 5), sizes, fsdp=True) == (None, None)
    assert tsharding.spec_for((10, 64, 32), sizes, n_scan_axes=1)[0] is None
    assert tsharding.spec_for((4, 64, 32), sizes,
                              replica_axis="data")[0] == "data"
    mesh = standin(("data", "model"), (4, 2))
    for shape in ((64, 32), (7, 5), (10, 64, 32), (4, 64, 32), (8,), ()):
        for kw in (dict(fsdp=True), dict(n_scan_axes=1),
                   dict(replica_axis="data"), dict(fsdp=True,
                                                   replica_axis="data")):
            if len(shape) <= kw.get("n_scan_axes", 0):
                continue
            assert tsharding.spec_for(shape, sizes, **kw) == tuple(
                jsharding.spec_for(shape, mesh, **kw)), (shape, kw)
