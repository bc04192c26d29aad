"""Serving launcher: batched generation with the smoke configs (port of
`repro.launch.serve`).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_370m \
        --requests 4 --max_new 32 [--device cpu]

Runs on the CUDA device unless `--device cpu` is given, over a data-axis
mesh (`launch.mesh.make_test_mesh(world, 1)`: one rank alone, every rank
under `torchrun`), as the reference's launcher serves over
`admission.data_axis_mesh`.
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt_len", type=int, default=16)
    ap.add_argument("--max_new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--use_kernels", action="store_true")
    ap.add_argument("--max_batch", type=int, default=0,
                    help="slot-table wave width (continuous batching; "
                         "0 = one wave for all requests)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.device import resolve
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model as model_lib
    from repro_torch.serving import engine as eng

    cfg = get_smoke_config(args.arch)
    dev = resolve(args.device)
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    world = dist.get_world_size() if dist.is_initialized() else 1
    # one data axis over every rank (the reference's data_axis_mesh)
    mesh = mesh_lib.make_test_mesh(world, 1, device=dev)
    params = model_lib.init_params(
        cfg, torch.Generator(dev).manual_seed(0), device=dev)
    e = eng.Engine(cfg, params,
                   max_seq=args.prompt_len + args.max_new + cfg.frontend_len,
                   use_kernels=args.use_kernels,
                   max_batch=args.max_batch or None, mesh=mesh, device=dev)
    rng = np.random.default_rng(0)
    reqs = [eng.Request(
        rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32),
        args.max_new) for _ in range(args.requests)]
    outs = e.generate(reqs, temperature=args.temperature)
    for i, o in enumerate(outs):
        print(f"request {i}: {o.tolist()}")
    st = e.stats()
    print(f"engine: {st.slices} decode steps, {st.compiles} distinct "
          f"shapes, {st.admitted} requests, occupancy {st.occupancy:.2f}")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
