"""Training launcher (port of `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi_6b --smoke \
        --device cpu --steps 20

runs on the card unless given `--device cpu`.  The run is laid over a
(`--data_axis`, `--model_axis`) device mesh (`launch.mesh`), whose size
must equal the number of ranks: under `torchrun` (or any launcher that
sets the rendezvous environment) each process joins the default group
(gloo on the CPU, NCCL on the card); alone, a (1, 1) mesh of one rank.
`--host_devices N` (the reference's emulated host devices) starts N gloo
ranks on the CPU itself and implies `--device cpu`:

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi_6b \
        --smoke --device cpu --host_devices 4 --data_axis 2 --model_axis 2

The consensus modes (`--dp_mode diffusion|admm`) hold one replica per
data coordinate, model-sharded inside.
"""
import argparse
import os


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global_batch", type=int, default=8)
    ap.add_argument("--seq_len", type=int, default=256)
    ap.add_argument("--dp_mode", default="allreduce",
                    choices=["allreduce", "diffusion", "admm"])
    ap.add_argument("--host_devices", type=int, default=0,
                    help="start N gloo ranks on the CPU (the reference's "
                         "emulated host devices)")
    ap.add_argument("--data_axis", type=int, default=1)
    ap.add_argument("--model_axis", type=int, default=1)
    ap.add_argument("--peak_lr", type=float, default=3e-4)
    ap.add_argument("--use_kernels", action="store_true")
    ap.add_argument("--ckpt_dir", default=None)
    ap.add_argument("--log_every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    args = ap.parse_args(argv)
    if args.host_devices:
        if args.device not in (None, "cpu"):
            raise ValueError("--host_devices runs gloo ranks on the CPU")
        args.device = "cpu"
        if args.data_axis * args.model_axis != args.host_devices:
            raise ValueError(
                f"--data_axis {args.data_axis} x --model_axis "
                f"{args.model_axis} must equal --host_devices "
                f"{args.host_devices}")
    return args


def main(argv=None):
    args = parse(argv)
    if args.host_devices and "WORLD_SIZE" not in os.environ:
        return _spawn(args, argv)
    run(args)


def run(args):
    import torch.distributed as dist

    from repro_torch.configs.base import get_config, get_smoke_config
    from repro_torch.device import resolve
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.training import train_step as ts
    from repro_torch.training.trainer import Trainer

    device = resolve(args.device)
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda"
                                else "gloo")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if args.data_axis * args.model_axis != world:
        raise ValueError(f"--data_axis {args.data_axis} x --model_axis "
                         f"{args.model_axis} must equal the number of "
                         f"ranks ({world})")
    mesh = mesh_lib.make_test_mesh(args.data_axis, args.model_axis,
                                   device=device)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    hyper = ts.TrainHyper(peak_lr=args.peak_lr, total_steps=args.steps,
                          warmup=max(args.steps // 10, 5))
    axis = "data" if args.dp_mode != "allreduce" else None
    trainer = Trainer(cfg, mesh, dp_mode=args.dp_mode, consensus_axis=axis,
                      hyper=hyper, global_batch=args.global_batch,
                      seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
                      device=device, use_kernels=args.use_kernels)
    trainer.run(args.steps, log_every=args.log_every)
    if args.ckpt_dir:
        path = trainer.save(args.steps)
        if path is not None:
            print("saved:", path)
    dist.destroy_process_group()


def _rank(rank: int, world: int, store: str, argv):
    """One of `--host_devices`' ranks: a gloo rank over a file store."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world)
    run(parse(argv))


def _spawn(args, argv):
    """Start `--host_devices` gloo ranks on this machine and wait for
    them (each runs `run`); raises if one fails."""
    import tempfile

    import torch.multiprocessing as mp
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(args.host_devices,
                                        os.path.join(tmp, "store"), argv),
                           nprocs=args.host_devices, start_method="spawn")


if __name__ == "__main__":
    main()
