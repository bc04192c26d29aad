"""Multi-pod dry run: the per-card roofline of a production step, counted
without allocating (port of `repro.launch.dryrun`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi_6b \
        --shape train_4k [--multi_pod | --both_meshes] [--dp_mode admm]

The reference lowers and compiles the step for 256 or 512 XLA host
placeholder devices from `ShapeDtypeStruct`s.  The port runs the step
once on meta tensors (`launch.specs`) under a counting dispatch mode
(`launch.hlo_analysis`), as rank 0 of a fake process group of 256 or 512
ranks (`fake_world`: `torch.distributed`'s "fake" backend, whose
collectives move nothing), so the (16, 16) and (2, 16, 16) production
meshes (`launch.mesh.make_production_mesh`) exist without their cards.
`main()` makes that world in its own process, where the reference sets
its device count on its first lines; `run_one` needs a world of the
mesh's size and raises without one, as `make_production_mesh` does.
The mesh's device type is the card's where there is one and the CPU's
elsewhere: nothing runs on it, but DTensor picks its collectives by it
(a CPU mesh turns an all-to-all into an all-gather), and the report
names it (`mesh_device`).

Homogeneous stacks of more than two layers are counted at 1 and 2
unstacked layers and extrapolated (`hlo_analysis.extrapolate_layers`),
as the reference does; other stacks at every layer.  The memory of an
extrapolated run: the arguments' local bytes exact, from the full-depth
specs; the outputs and the temp peak extrapolated the same way.
`compile_s` is the counting runs' seconds.  `--use_kernels` counts the
kernels' custom ops by their formulas; with a train shape it raises,
as `train_step.make_train_step` does (the kernels have no backward).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os

import torch
import torch.distributed as dist

from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.launch import hlo_analysis, specs
from repro_torch.launch.mesh import make_production_mesh, n_chips
from repro_torch.models.model import _homogeneous, param_count


@contextlib.contextmanager
def fake_world(n: int):
    """This process as rank 0 of a fake process group of `n` ranks (no
    peers, no network; its collectives return shapes), destroyed on
    exit.  Raises if a default group exists already."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group exists already: the dry run's "
                           "fake world needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_device() -> str:
    """The production mesh's device type: the card's where there is one
    and the fake backend serves it (it registers for "cuda"), else the
    CPU's."""
    if torch.cuda.is_available() and "cuda" in \
            dist.Backend.backend_capability.get("fake", ()):
        return "cuda"
    return "cpu"


def _count(cfg, shape, mesh, dp_mode, consensus_axis, use_kernels):
    fn, in_specs = specs.build_step(cfg, shape, mesh, dp_mode=dp_mode,
                                    consensus_axis=consensus_axis,
                                    use_kernels=use_kernels)
    return hlo_analysis.count(fn, in_specs)


def model_flops(cfg, shape) -> float:
    """6*N_active*D for train (fwd+bwd), 2*N_active*D inference."""
    n_active = param_count(cfg, active_only=True)
    n_tok = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                  else 1)
    return (6.0 if shape.kind == "train" else 2.0) * n_active * n_tok


def _ext(a, b, n_layers):
    return a + (n_layers - 1) * (b - a)


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            dp_mode: str = "allreduce", use_kernels: bool = False,
            verbose: bool = True, cfg_override=None) -> dict:
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    if use_kernels and shape.kind == "train":
        raise RuntimeError(
            "the kernels have no backward (nor have the JAX package's "
            "Pallas kernels): dry-run a train shape without --use_kernels")
    mesh = make_production_mesh(multi_pod=multi_pod, device=mesh_device())
    consensus_axis = None
    if dp_mode != "allreduce":
        consensus_axis = "pod" if multi_pod else "data"

    mf = model_flops(cfg, shape)
    chips = n_chips(mesh)

    if _homogeneous(cfg) and cfg.n_layers > 2:
        # every layer runs the same ops on the same shapes: count 1- and
        # 2-layer unstacked steps and extrapolate, as the reference does
        c1, c2 = (_count(cfg.replace(n_layers=n, scan_layers=False), shape,
                         mesh, dp_mode, consensus_axis, use_kernels)
                  for n in (1, 2))
        roof = hlo_analysis.extrapolate_layers(
            hlo_analysis.roofline(c1, chips, mf),
            hlo_analysis.roofline(c2, chips, mf), cfg.n_layers)
        m1, m2 = (hlo_analysis.memory_per_device(c) for c in (c1, c2))
        mem = {k: (_ext(m1[k], m2[k], cfg.n_layers) if m1[k] is not None
                   else None) for k in m1}
        mem["argument_size_in_bytes"] = hlo_analysis.local_bytes(
            specs.input_specs(cfg, shape, mesh,
                              dp_mode=dp_mode,
                              consensus_axis=consensus_axis))
        kernel_calls = {k: _ext(c1.kernel_calls.get(k, 0),
                                c2.kernel_calls.get(k, 0), cfg.n_layers)
                        for k in set(c1.kernel_calls) | set(c2.kernel_calls)}
        t_count = c1.seconds + c2.seconds
    else:
        # every layer is counted: exact
        c = _count(cfg, shape, mesh, dp_mode, consensus_axis, use_kernels)
        roof = hlo_analysis.roofline(c, chips, mf)
        mem = hlo_analysis.memory_per_device(c)
        kernel_calls = dict(c.kernel_calls)
        t_count = c.seconds

    report = {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "mesh_device": mesh.device_type,
        "dp_mode": dp_mode, "use_kernels": use_kernels,
        "lower_s": 0.0, "compile_s": round(t_count, 1),
        "memory_analysis": mem, "kernel_calls": kernel_calls,
        **roof.as_dict(),
    }
    if verbose:
        gb = (mem.get("argument_size_in_bytes") or 0) / 2**30
        tmp = (mem.get("temp_size_in_bytes") or 0) / 2**30
        print(f"[dryrun] {arch:24s} {shape_name:12s} "
              f"{report['mesh']:8s} {dp_mode:9s} "
              f"args/dev {gb:8.2f} GiB  temp/dev {tmp:7.2f} GiB  "
              f"Tc {roof.t_compute*1e3:9.3f} ms  Tm {roof.t_memory*1e3:9.3f} ms"
              f"  Tcoll {roof.t_collective*1e3:9.3f} ms  "
              f"-> {roof.bottleneck:10s} useful {roof.useful_flops_ratio:.2f}"
              f"  (count {t_count:.0f}s)", flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description="Multi-pod dry-run")
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all'")
    ap.add_argument("--shape", default="all",
                    help="input shape name or 'all'")
    ap.add_argument("--multi_pod", action="store_true")
    ap.add_argument("--both_meshes", action="store_true",
                    help="run 16x16 AND 2x16x16 for each pair")
    ap.add_argument("--dp_mode", default="allreduce",
                    choices=["allreduce", "diffusion", "admm"])
    ap.add_argument("--use_kernels", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = (list(INPUT_SHAPES) if args.shape == "all" else [args.shape])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    torch.set_num_threads(1)          # shapes only: nothing to parallelise
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for mp in meshes:
        with fake_world(512 if mp else 256):
            for arch in archs:
                for shape in shapes:
                    tag = (f"{arch}_{shape}_{'2x16x16' if mp else '16x16'}"
                           f"_{args.dp_mode}"
                           + ("_kern" if args.use_kernels else ""))
                    try:
                        rep = run_one(arch, shape, multi_pod=mp,
                                      dp_mode=args.dp_mode,
                                      use_kernels=args.use_kernels)
                        with open(os.path.join(args.out, tag + ".json"),
                                  "w") as f:
                            json.dump(rep, f, indent=1)
                    except Exception as e:  # noqa: BLE001 (report, go on)
                        failures.append((tag, repr(e)))
                        print(f"[dryrun] FAIL {tag}: {e!r}", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(" ", tag, err[:200])
        raise SystemExit(1)
    print("\nall dry-runs compiled OK")


if __name__ == "__main__":
    main()
