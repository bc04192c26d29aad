"""Meta-tensor input specs + step factories for the dry run (port of
`repro.launch.specs`).

Everything here is allocation-free: where the reference makes
`ShapeDtypeStruct`s carrying `NamedSharding`s from `jax.eval_shape`, the
port makes DTensors whose local shards live on the meta device, laid out
by the same policy (`dist.sharding`): the model from `LM(cfg,
device="meta", init=False)`, the training state from
`train_step.init_state(mesh=)`, the decode cache by
`engine.cache_shardings`.  So a 314B-parameter training step on 512
ranks costs only the host's time to run its ops on shapes.  The mesh is
a `DeviceMesh` over a world of its size (the dry run's is a fake process
group, `launch.dryrun`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.dist import sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as model_lib
from repro_torch.serving import engine
from repro_torch.training import train_step as ts

SLIDING_WINDOW_LONG = 4096   # documented long_500k variant for full-attn archs
TOKEN_DTYPE = torch.int32    # the reference's token ids
FRONTEND_DTYPE = torch.bfloat16


def _meta(shape, dtype, mesh, spec):
    """A meta DTensor of global `shape` laid out by `spec`."""
    return sharding.zeros(shape, dtype, "meta", mesh,
                          sharding.placements(spec, mesh))


def _batch_axes(mesh, batch: int):
    """Greedy batch sharding over (pod, data): only axes that divide."""
    sizes = mesh_lib.axis_sizes(mesh)
    axes = []
    rem = batch
    for a in ("pod", "data"):
        if a in sizes and rem % sizes[a] == 0:
            axes.append(a)
            rem //= sizes[a]
    return tuple(axes)


def arch_variant(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """long_500k needs sub-quadratic attention: SSM/hybrid archs are
    natively sub-quadratic; full-attention archs run the documented
    sliding-window variant (DESIGN.md §5)."""
    if shape.name == "long_500k" and cfg.window == 0 and any(
            k == "attn" for k in cfg.layer_kinds()):
        return cfg.replace(window=SLIDING_WINDOW_LONG, windowed_kv=True)
    return cfg


def _params(cfg: ModelConfig, mesh):
    """The model on meta, laid out as the reference's prefill/decode
    params (fsdp as the config says)."""
    lm = model_lib.LM(cfg, device="meta", init=False)
    return sharding.distribute(lm, mesh, sharding.param_shardings(
        dict(lm.named_parameters()), mesh, fsdp=cfg.fsdp,
        scanned=model_lib._homogeneous(cfg),
        no_fsdp_keys=("moe",) if cfg.moe_local_dispatch else ()))


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                dp_mode: str = "allreduce",
                consensus_axis: Optional[str] = None) -> dict:
    """Meta stand-ins for every input of the step being counted.

    train  -> {"state": TrainState, "batch": {tokens[, frontend]}}
    prefill-> {"params", "tokens"[, "frontend"]}
    decode -> {"params", "token", "cache", "pos"}

    `pos` is a Python int (the port's decode step takes one): the last
    slot of the cache, where the reference's is a traced int32 scalar.
    """
    cfg = arch_variant(cfg, shape)
    bspec = (sharding.axes_entry(_batch_axes(mesh, shape.global_batch)),)
    B, S = shape.global_batch, shape.seq_len

    def frontend(out):
        if cfg.frontend != "none":
            out["frontend"] = _meta((B, cfg.frontend_len, cfg.d_model),
                                    FRONTEND_DTYPE, mesh, bspec)
        return out

    if shape.kind == "train":
        state = ts.init_state(
            cfg, dp_mode=dp_mode, mesh=mesh, consensus_axis=consensus_axis,
            params=model_lib.LM(cfg, device="meta", init=False))
        batch = frontend({"tokens": _meta((B, S), TOKEN_DTYPE, mesh, bspec)})
        return {"state": state, "batch": batch}

    params = _params(cfg, mesh)
    if shape.kind == "prefill":
        return frontend({"params": params,
                         "tokens": _meta((B, S), TOKEN_DTYPE, mesh, bspec)})

    # decode: ONE new token against a cache of seq_len
    shapes = model_lib.init_cache(cfg, B, S, torch.bfloat16, device="meta")
    cache = [tuple(_meta(t.shape, t.dtype, mesh, sp)
                   for t, sp in zip(entry, spec))
             for entry, spec in zip(shapes,
                                    engine.cache_shardings(shapes, cfg,
                                                           mesh))]
    return {"params": params,
            "token": _meta((B, 1), TOKEN_DTYPE, mesh, bspec),
            "cache": cache, "pos": S - 1}


def _whole(t):
    """The global batch a train step takes (every rank holds it whole):
    for a meta DTensor a meta tensor of its global shape (there is
    nothing to gather), else the gathered tensor."""
    if t.is_meta:
        return torch.empty(t.shape, dtype=t.dtype, device="meta")
    return sharding.full(t)


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               dp_mode: str = "allreduce",
               consensus_axis: Optional[str] = None,
               use_kernels: bool = False):
    """Returns (fn, kwargs_specs) ready for `hlo_analysis.analyze(fn,
    specs, ...)` (or `fn(**specs)`)."""
    cfg = arch_variant(cfg, shape)
    specs = input_specs(cfg, shape, mesh, dp_mode=dp_mode,
                        consensus_axis=consensus_axis)
    if shape.kind == "train":
        step = ts.make_train_step(cfg, mesh, dp_mode=dp_mode,
                                  consensus_axis=consensus_axis,
                                  use_kernels=use_kernels)

        def fn(state, batch):
            return step(state, {k: _whole(v) for k, v in batch.items()})

        return fn, specs
    if shape.kind == "prefill":
        pre = engine.make_prefill_step(cfg, use_kernels=use_kernels)

        def prefill(params, tokens, frontend=None):
            with torch.no_grad(), sharding.use_mesh(mesh):
                return pre(params, tokens, frontend)

        return prefill, specs

    dec = engine.make_decode_step(cfg)

    def decode(params, token, cache, pos):
        with torch.no_grad(), sharding.use_mesh(mesh):
            return dec(params, token, cache, pos)

    return decode, specs
