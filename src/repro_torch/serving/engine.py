"""Serving engine: batched prefill + greedy/temperature decode (port of
`repro.serving.engine`).

`make_prefill_step` and `make_decode_step` are the two step functions;
`Engine` is the host-side driver: it admits a batch of requests, prefills
them (right-aligned padding) with the kernels when `use_kernels`, then
decodes until every request has its tokens.  A config with a modality
frontend prefills with zero stub embeddings in its first `frontend_len`
positions, as the reference does.

`Engine(mesh=)` serves over a device mesh (`launch.mesh`): the
parameters are DTensors by `dist.sharding.param_shardings` (no fsdp when
serving), each wave's rows go over the data axes, the decode cache is
laid out by `cache_shardings` and written in place slot by slot, and
prefill and decode run under `dist.sharding.use_mesh`.  Every rank runs
the same requests and gets the tokens whole.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.dist import sharding
from repro_torch.models import model as model_lib
from repro_torch.serving import admission
from repro_torch.serving.driver import ArrivalQueue, DriverStats, SlotTable


def cache_shardings(cache, cfg: ModelConfig, mesh) -> list:
    """The decode cache's specs, leaf for leaf the reference's: the batch
    over the dp axes ("pod", "data") that divide it (`long_500k` has
    B = 1), and the last trailing dim (after the batch) that divides
    "model" over it (head_dim, or the kv heads, or the state channels).
    The port's cache is a list of per-layer tuples where the reference
    stacks a homogeneous model's layers: a layer's spec is the stacked
    leaf's with the layer entry dropped.  `mesh` may be a `DeviceMesh` or
    a {name: size} mapping."""
    sizes = sharding.axis_sizes(mesh)
    model_ax = sizes.get("model", 1)
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    lead = 1 if model_lib._homogeneous(cfg) else 0   # the layer axis

    def one(leaf) -> tuple:
        shape = (1,) * lead + tuple(leaf.shape)
        rank = len(shape)
        spec: list = [None] * rank
        if rank > lead:
            ok, rem = [], shape[lead]
            for a in dp_axes:
                if rem % sizes[a] == 0 and sizes[a] > 1:
                    ok.append(a)
                    rem //= sizes[a]
            spec[lead] = sharding.axes_entry(ok)
        for ax in range(rank - 1, lead, -1):
            if model_ax > 1 and shape[ax] % model_ax == 0 \
                    and shape[ax] >= 2 * model_ax:
                spec[ax] = "model"
                break
        return tuple(spec[lead:])

    return [tuple(one(t) for t in entry) for entry in cache]


def frontend_stub(cfg: ModelConfig, batch: int, device):
    """The (B, frontend_len, d_model) f32 zeros the reference's engine
    feeds a config with a modality frontend; None without one."""
    if cfg.frontend == "none":
        return None
    return torch.zeros((batch, cfg.frontend_len, cfg.d_model),
                       dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------
def make_prefill_step(cfg: ModelConfig, *, use_kernels: bool = False):
    def prefill_step(params, tokens, frontend=None):
        out = model_lib.forward(cfg, params, tokens, frontend,
                                collect_cache=True, use_kernels=use_kernels)
        return out["logits"][:, -1:, :], out["cache"]

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, token, cache, pos):
        return model_lib.decode_step(cfg, params, token, cache, pos)

    return decode_step


# ---------------------------------------------------------------------------
# Host-side engine
# ---------------------------------------------------------------------------
class Request(NamedTuple):
    prompt: np.ndarray        # (plen,) int32
    max_new_tokens: int


class Engine:
    """Host-side LM driver, scheduled with the serving stack's primitives
    (`serving/driver.py`): requests go through an `ArrivalQueue` into
    `SlotTable` waves of at most `max_batch` slots, the decode loop keeps
    a per-slot ACTIVE mask (a request that has all its tokens is
    idle-masked while its wave-mates keep decoding), and `stats()` reports
    the `DriverStats` counters.  `max_batch=None` admits every request in
    one wave.

    `bucket` enables prompt-LENGTH bucketing through the capacity ladder
    (`admission.bucket_capacity`): each wave admits only prompts sharing a
    ladder rung and left-pads to the rung (not to the wave max), so a
    request's greedy output is a function of (prompt, rung) alone.
    "pow2" = power-of-two rungs, a float > 1 = custom growth factor, None
    (default) = wave-max padding.

    `params` is an `LM` on `device` (None means the CUDA device).  Greedy
    output is the JAX engine's; temperature sampling draws Gumbel noise
    from a `torch.Generator` seeded with `seed`, which cannot reproduce
    `jax.random`.  `stats().compiles` counts the distinct prefill and
    decode batch shapes (the JAX engine counts its jit cache entries, one
    per shape; the port compiles nothing).
    """

    def __init__(self, cfg: ModelConfig, params, *, max_seq: int = 1024,
                 use_kernels: bool = False, seed: int = 0,
                 max_batch: Optional[int] = None,
                 bucket: Optional[str | float] = None,
                 bucket_min: int = 8, mesh=None, device=None):
        self.device = resolve(device)
        if params.device.type != self.device.type:
            raise ValueError(f"params are on {params.device}, the engine "
                             f"runs on {self.device}")
        if mesh is not None:
            if mesh.device_type != self.device.type:
                raise ValueError(f"the mesh is on {mesh.device_type}, the "
                                 f"engine runs on {self.device}")
            params = sharding.distribute_copy(
                params, mesh, sharding.param_shardings(
                    dict(params.named_parameters()), mesh,
                    scanned=model_lib._homogeneous(cfg)))
        self.mesh = mesh
        self.cfg, self.params = cfg, params
        self.max_seq = max_seq
        self.max_batch = max_batch
        if bucket is None or bucket == "pow2":
            self._bucket_growth = 2.0 if bucket == "pow2" else None
        else:
            self._bucket_growth = float(bucket)
        self.bucket = bucket
        self.bucket_min = int(bucket_min)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self._prefill = make_prefill_step(cfg, use_kernels=use_kernels)
        self._decode = make_decode_step(cfg)
        self._shapes: set[tuple] = set()   # distinct prefill/decode shapes
        self._steps = 0                 # decode steps dispatched
        self._waves = 0
        self._n_admitted = 0
        self._occ_active = 0            # sum of active slots over steps
        self._occ_slots = 0             # sum of wave widths over steps

    def generate(self, requests: list[Request], *,
                 temperature: float = 0.0) -> list[np.ndarray]:
        """Batched greedy/temperature generation.  With `max_batch` set,
        requests beyond the wave width wait in the arrival queue and run
        as follow-up waves once a wave's slots drain."""
        queue = ArrivalQueue()
        for i in range(len(requests)):
            queue.push(i)
        results: list[Optional[np.ndarray]] = [None] * len(requests)
        while len(queue):
            table = SlotTable(self.max_batch if self.max_batch is not None
                              else max(len(queue), 1))
            wave = []
            wave_rung = None
            for entry in queue.pop_ready(0.0):
                rung = self._rung(requests[entry[2]])
                if wave_rung is None and not wave:
                    wave_rung = rung            # head of queue sets the rung
                if rung != wave_rung \
                        or table.alloc(f"r{entry[2]}") is None:
                    queue.push_entry(entry)     # next wave
                else:
                    wave.append(entry[2])
            outs = self._generate_wave([requests[i] for i in wave],
                                       temperature, wave_rung)
            for i, out in zip(wave, outs):
                results[i] = out
            self._waves += 1
            self._n_admitted += len(wave)
        return results

    def _rung(self, r: Request) -> Optional[int]:
        """Prompt-length ladder rung (None with bucketing off)."""
        if self.bucket is None:
            return None
        need = max(len(r.prompt), self.cfg.frontend_len + 1)
        return admission.bucket_capacity(need,
                                         growth=self._bucket_growth,
                                         min_size=self.bucket_min)

    def context(self):
        """The mode the engine's steps run in: inference mode; under a
        mesh, no_grad (DTensor views of parameters cannot be made in
        inference mode) and the ambient mesh."""
        if self.mesh is None:
            return torch.inference_mode()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.no_grad())
        stack.enter_context(sharding.use_mesh(self.mesh))
        return stack

    def _generate_wave(self, requests: list[Request],
                       temperature: float,
                       rung: Optional[int] = None) -> list[np.ndarray]:
        with self.context():
            return self._wave(requests, temperature, rung)

    def _rows(self, t):
        """A host-made batch tensor with its rows over the data axes (as
        it is without a mesh)."""
        if self.mesh is None or t is None:
            return t
        return sharding.to_dtensor(t, self.mesh, sharding.placements_for(
            self.mesh, batch=t.shape[0]))

    def _wave(self, requests: list[Request], temperature: float,
              rung: Optional[int]) -> list[np.ndarray]:
        cfg = self.cfg
        B = len(requests)
        plen = rung if rung is not None else max(
            max(len(r.prompt) for r in requests), cfg.frontend_len + 1)
        toks = admission.right_aligned_batch(
            [r.prompt for r in requests], length=plen)
        max_new = max(r.max_new_tokens for r in requests)
        total = min(self.max_seq, plen + max_new)
        # per-slot active mask: slot i needs tokens until plen+max_new_i
        need = np.array([min(self.max_seq, plen + r.max_new_tokens)
                         for r in requests])

        self._shapes.add(("prefill", B, plen))
        logits, cache = self._prefill(
            self.params, self._rows(torch.as_tensor(
                toks, dtype=torch.int64, device=self.device)),
            self._rows(frontend_stub(cfg, B, self.device)))
        # re-home the prefill cache into a full-length f32 decode cache
        full = self._decode_cache(B, total)
        cache = _splice_cache(cfg, full, cache, plen)
        out = [toks]
        cur = _sample(logits, temperature, self.generator)
        for t in range(plen, total):
            active = int((need > t).sum())
            if active == 0:         # every slot has its tokens
                break
            self._steps += 1
            self._occ_active += active
            self._occ_slots += B
            out.append(sharding.full(cur).cpu().numpy().astype(np.int32))
            self._shapes.add(("decode", B, total))
            logits, cache = self._decode(self.params, cur, cache, t)
            cache = self._at_rest(cache, full)
            cur = _sample(logits, temperature, self.generator)
        seq = np.concatenate(out, axis=1)
        return [seq[i, plen - len(r.prompt):plen + r.max_new_tokens]
                for i, r in enumerate(requests)]

    def _decode_cache(self, B: int, total: int) -> list:
        """The empty f32 decode cache; under a mesh each rank allocates
        its block of every leaf (`cache_shardings`)."""
        if self.mesh is None:
            return model_lib.init_cache(self.cfg, B, total, torch.float32,
                                        device=self.device)
        shapes = model_lib.init_cache(self.cfg, B, total, torch.float32,
                                      device="meta")
        specs = cache_shardings(shapes, self.cfg, self.mesh)
        return [tuple(sharding.zeros(t.shape, t.dtype, self.device,
                                     self.mesh,
                                     sharding.placements(sp, self.mesh))
                      for t, sp in zip(entry, spec))
                for entry, spec in zip(shapes, specs)]

    def _at_rest(self, cache: list, like: list) -> list:
        """A decode step's cache back in the layout of `like` (under a
        mesh the recurrent states come back from their per-row regions
        replicated over "model"; the attention entries are written in
        place and keep theirs)."""
        if self.mesh is None:
            return cache
        return [tuple(sharding.relayout(t, self.mesh, d.placements)
                      for t, d in zip(entry, ref))
                for entry, ref in zip(cache, like)]

    def stats(self) -> DriverStats:
        """The VB driver's counters, LM flavour: slices = decode steps,
        occupancy = time-averaged active/width over decode steps."""
        occ = (self._occ_active / self._occ_slots
               if self._occ_slots else 0.0)
        return DriverStats(
            slices=self._steps, compiles=len(self._shapes),
            admitted=self._n_admitted, evicted=self._n_admitted,
            queue_depth=0, active=0,
            capacity=self.max_batch or 0, occupancy=occ,
            padding_waste=(1.0 - occ) if self._occ_slots else 0.0,
            checkpoints=0)


def _sample(logits, temperature: float, generator: torch.Generator):
    """(B, 1) next tokens: argmax, or argmax of logits / T + Gumbel noise
    (under a mesh a DTensor with the rows over the data axes; every rank
    draws the same noise)."""
    last = sharding.constrain_batch_dim(logits[:, -1, :])
    if temperature <= 0.0:
        return last.argmax(dim=-1, keepdim=True)
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(last.shape, generator=generator, device=last.device)
    g = -torch.log(-torch.log(u.clamp_min(tiny)))
    return (last / temperature + g).argmax(dim=-1, keepdim=True)


def _splice_cache(cfg: ModelConfig, full: list, prefill: list,
                  plen: int) -> list:
    """Copy the prefill cache into the (longer) decode cache buffers, cast
    to their dtype (attention K/V at offset 0, in place; the rec and ssm
    states (conv_buf, h) replace the empty ones)."""
    out = []
    for kind, dst, src in zip(cfg.layer_kinds(), full, prefill):
        if kind == "attn":
            for d, s in zip(dst, src):
                if isinstance(d, DTensor):      # each rank its own block
                    s = sharding.relayout(s, d.device_mesh, d.placements)
                    d, s = d.to_local(), s.to_local()
                d[:, :s.shape[1]] = s.to(d.dtype)
            out.append(dst)
        else:
            out.append(tuple(_relaid(s.to(d.dtype), d)
                             for d, s in zip(dst, src)))
    return out


def _relaid(t, like):
    """`t` in the layout of `like` (a DTensor's placements; a tensor as
    it is)."""
    if isinstance(like, DTensor):
        return sharding.relayout(t, like.device_mesh, like.placements)
    return t
