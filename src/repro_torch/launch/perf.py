"""Perf-iteration runner (port of `repro.launch.perf`).

Runs a named (arch, shape) pair under a sequence of CONFIG VARIANTS
(sharding / remat / dtype / dp_mode / kernel knobs), re-counts the dry
run (`launch.dryrun.run_one`) and prints the roofline delta vs the
baseline.  Results accumulate in experiments/perf/<arch>_<shape>.json.

    PYTHONPATH=src python -m repro_torch.launch.perf --arch yi_6b \
        --shape train_4k --variants baseline,noremat,diffusion,admm

Like `launch.dryrun.main`, `main()` runs as rank 0 of a fake world of
the production mesh's size (`dryrun.fake_world`), made in its own
process.
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.configs.base import get_config
from repro_torch.launch import dryrun


def variant_space(cfg):
    """Named config/step variants for hillclimbing."""
    return {
        # paper-faithful baseline: allreduce DP + fsdp + remat
        "baseline": dict(cfg=cfg, dp_mode="allreduce"),
        # iteration snapshot names (same config, code-level sharding fixes;
        # the 'measure' step of hypothesis->change->measure cycles)
        "shardfix": dict(cfg=cfg, dp_mode="allreduce"),
        "shardfix2": dict(cfg=cfg, dp_mode="allreduce"),
        # activation-checkpointing OFF (memory for compute trade)
        "noremat": dict(cfg=cfg.replace(remat=False), dp_mode="allreduce"),
        # fsdp OFF (replicated weights: kills per-layer weight all-gathers,
        # costs memory)
        "nofsdp": dict(cfg=cfg.replace(fsdp=False), dp_mode="allreduce"),
        "nofsdp_noremat": dict(cfg=cfg.replace(fsdp=False, remat=False),
                               dp_mode="allreduce"),
        # the paper's technique: consensus instead of exact averaging
        "diffusion": dict(cfg=cfg, dp_mode="diffusion"),
        "admm": dict(cfg=cfg, dp_mode="admm"),
        "diffusion_noremat": dict(cfg=cfg.replace(remat=False),
                                  dp_mode="diffusion"),
        # f32 master activations (numerics-vs-bytes trade)
        "f32_compute": dict(cfg=cfg.replace(compute_dtype="float32"),
                            dp_mode="allreduce"),
        # MoE capacity trades (MoE archs only)
        "cap1": dict(cfg=cfg.replace(capacity_factor=1.0),
                     dp_mode="allreduce"),
        "cap2": dict(cfg=cfg.replace(capacity_factor=2.0),
                     dp_mode="allreduce"),
        # flat-head GQA layout: head axis shards over "model" cleanly
        "flat_heads": dict(cfg=cfg.replace(attn_flat_heads=True),
                           dp_mode="allreduce"),
        # sliding-window archs: per-chunk KV slice instead of mask
        "windowed_kv": dict(cfg=cfg.replace(windowed_kv=True),
                            dp_mode="allreduce"),
        "flat_windowed": dict(cfg=cfg.replace(attn_flat_heads=True,
                                              windowed_kv=True),
                              dp_mode="allreduce"),
        "flat_noremat": dict(cfg=cfg.replace(attn_flat_heads=True,
                                             remat=False),
                             dp_mode="allreduce"),
        "flat_diffusion": dict(cfg=cfg.replace(attn_flat_heads=True),
                               dp_mode="diffusion"),
        # MoE per-shard dispatch (Switch per-core capacity semantics)
        "local_dispatch": dict(cfg=cfg.replace(moe_local_dispatch=True),
                               dp_mode="allreduce"),
        "local_dispatch_cap1": dict(
            cfg=cfg.replace(moe_local_dispatch=True, capacity_factor=1.0),
            dp_mode="allreduce"),
        # smaller attention q-chunks (peak-memory lever)
        "qchunk512": dict(cfg=cfg.replace(attn_q_chunk=512),
                          dp_mode="allreduce"),
        "qchunk256": dict(cfg=cfg.replace(attn_q_chunk=256),
                          dp_mode="allreduce"),
        # pad vocab to a multiple of the model axis (sharded unembed)
        "padvocab": dict(cfg=cfg.replace(
            vocab_pad=-(-cfg.vocab_size // 16) * 16), dp_mode="allreduce"),
        "padvocab_cap1": dict(cfg=cfg.replace(
            vocab_pad=-(-cfg.vocab_size // 16) * 16, capacity_factor=1.0),
            dp_mode="allreduce"),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi_pod", action="store_true")
    ap.add_argument("--variants", default="baseline")
    ap.add_argument("--out", default="experiments/perf")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    space = variant_space(cfg)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{args.arch}_{args.shape}"
                        f"{'_2pod' if args.multi_pod else ''}.json")
    results = {}
    if os.path.exists(path):
        with open(path) as f:
            results = json.load(f)

    torch.set_num_threads(1)          # shapes only: nothing to parallelise
    base = results.get("baseline")
    with dryrun.fake_world(512 if args.multi_pod else 256):
        for name in args.variants.split(","):
            v = space[name]
            rep = dryrun.run_one(args.arch, args.shape,
                                 multi_pod=args.multi_pod,
                                 dp_mode=v["dp_mode"], cfg_override=v["cfg"],
                                 verbose=False)
            results[name] = rep
            if name == "baseline":
                base = rep
            line = (f"[perf] {name:20s} Tc {rep['t_compute_s']*1e3:9.2f} ms  "
                    f"Tm {rep['t_memory_s']*1e3:9.2f} ms  "
                    f"Tcoll {rep['t_collective_s']*1e3:9.2f} ms  "
                    f"-> {rep['bottleneck']}")
            if base and name != "baseline":
                for k, key in [("Tc", "t_compute_s"), ("Tm", "t_memory_s"),
                               ("Tcoll", "t_collective_s")]:
                    d = (rep[key] - base[key]) / max(base[key], 1e-12) * 100
                    line += f"  d{k} {d:+.1f}%"
            print(line, flush=True)
            with open(path, "w") as f:
                json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
