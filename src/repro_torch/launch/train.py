"""Training launcher (port of `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi_6b --smoke \\
        --device cpu --steps 20

runs on the card unless given `--device cpu`.  The consensus modes
(`--dp_mode diffusion|admm`) run one replica per rank of a
`torch.distributed` group: under `torchrun` (or any launcher that sets
the rendezvous environment) each process joins the default group (gloo
on the CPU, NCCL on the card), and `--data_axis` must equal the group's
size; alone, a one-rank group.  `--model_axis > 1` and `--host_devices`
(the reference's emulated mesh) are ROADMAP Queue 1 item 16's LM
sharding and raise.
"""
import argparse
import os


def main(argv=None):
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
                    help="the reference's emulated host devices (not "
                         "ported)")
    ap.add_argument("--data_axis", type=int, default=1)
    ap.add_argument("--model_axis", type=int, default=1)
    ap.add_argument("--peak_lr", type=float, default=3e-4)
    ap.add_argument("--use_kernels", action="store_true")
    ap.add_argument("--ckpt_dir", default=None)
    ap.add_argument("--log_every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    args = ap.parse_args(argv)

    if args.model_axis > 1 or args.host_devices:
        raise NotImplementedError(
            "--model_axis > 1 and --host_devices shard the model over a "
            "mesh: not ported (ROADMAP Queue 1 item 16: LM sharding)")

    import torch.distributed as dist

    from repro_torch.configs.base import get_config, get_smoke_config
    from repro_torch.device import resolve
    from repro_torch.dist import collectives
    from repro_torch.serving import admission
    from repro_torch.training import train_step as ts
    from repro_torch.training.trainer import Trainer

    device = resolve(args.device)
    executor = None
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda"
                                else "gloo")
    if args.dp_mode != "allreduce" or dist.is_initialized():
        executor = admission.data_axis_mesh(device=device)
        n = collectives.axis_size(executor)
        if args.data_axis != n:
            raise ValueError(f"--data_axis={args.data_axis} must equal the "
                             f"group's size ({n} ranks)")
    elif args.data_axis != 1:
        raise ValueError(f"--data_axis={args.data_axis} needs a group of "
                         f"that many ranks (torchrun)")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    hyper = ts.TrainHyper(peak_lr=args.peak_lr, total_steps=args.steps,
                          warmup=max(args.steps // 10, 5))
    trainer = Trainer(cfg, executor, dp_mode=args.dp_mode, hyper=hyper,
                      global_batch=args.global_batch, seq_len=args.seq_len,
                      ckpt_dir=args.ckpt_dir, device=device,
                      use_kernels=args.use_kernels)
    trainer.run(args.steps, log_every=args.log_every)
    if args.ckpt_dir:
        path = trainer.save(args.steps)
        if path is not None:
            print("saved:", path)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
