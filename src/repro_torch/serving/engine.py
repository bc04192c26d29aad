"""Serving engine: batched prefill + greedy/temperature decode (port of
`repro.serving.engine`).

`make_prefill_step` and `make_decode_step` are the two step functions;
`Engine` is the host-side driver: it admits a batch of requests, prefills
them (right-aligned padding) with the kernels when `use_kernels`, then
decodes until every request has its tokens.  A config with a modality
frontend prefills with zero stub embeddings in its first `frontend_len`
positions, as the reference does.  Meshes and cache shardings are not
ported (ROADMAP Queue 1 item 16: LM sharding).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import model as model_lib
from repro_torch.serving import admission
from repro_torch.serving.driver import ArrivalQueue, DriverStats, SlotTable


def cache_shardings(*args, **kwargs):
    raise NotImplementedError("cache shardings over a device mesh are not "
                              "ported (ROADMAP Queue 1 item 16: LM "
                              "sharding)")


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
        if mesh is not None:
            raise NotImplementedError("a device mesh is not ported "
                                      "(ROADMAP Queue 1 item 16: LM "
                                      "sharding)")
        self.device = resolve(device)
        if params.device.type != self.device.type:
            raise ValueError(f"params are on {params.device}, the engine "
                             f"runs on {self.device}")
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

    @torch.inference_mode()
    def _generate_wave(self, requests: list[Request],
                       temperature: float,
                       rung: Optional[int] = None) -> list[np.ndarray]:
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
            self.params, torch.as_tensor(toks, dtype=torch.int64,
                                         device=self.device),
            frontend_stub(cfg, B, self.device))
        # re-home the prefill cache into a full-length f32 decode cache
        full = model_lib.init_cache(cfg, B, total, torch.float32,
                                    device=self.device)
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
            out.append(cur.cpu().numpy().astype(np.int32))
            self._shapes.add(("decode", B, total))
            logits, cache = self._decode(self.params, cur, cache, t)
            cur = _sample(logits, temperature, self.generator)
        seq = np.concatenate(out, axis=1)
        return [seq[i, plen - len(r.prompt):plen + r.max_new_tokens]
                for i, r in enumerate(requests)]

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
    """(B, 1) next tokens: argmax, or argmax of logits / T + Gumbel noise."""
    last = logits[:, -1, :]
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
                d[:, :s.shape[1]] = s.to(d.dtype)
            out.append(dst)
        else:
            out.append(tuple(s.to(d.dtype) for d, s in zip(dst, src)))
    return out
