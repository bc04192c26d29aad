"""Quick card check of the port's LM kernels, without the serving phases.

    python3 tools/lm_kernels_check.py

Run from the repository root on a machine with a CUDA card.  It builds
the kernels of src/repro_torch/csrc (chip_smoke.py's build phase), holds
flash_attention and ssd_scan against their plain versions at the
tests/test_kernels.py shapes and at the Yi-6B / Mamba-2 prefill shapes
(chip_smoke.py's cases and bars), times both at the prefill shapes
(chip_smoke.py's `_time_flash` / `_time_ssd`), and lists each device
kernel's time per call from a profile of ten calls (the ssd wrapper
launches three).  One JSON line per case; exits non-zero if any failed.
It takes about 40 s on an H100, against chip_smoke.py's ~150 s.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

FLASH_SHAPES = ((2, 64, 4, 2, 32), (1, 128, 2, 1, 64), (2, 96, 4, 4, 16),
                (1, 256, 8, 2, 128), (1, 1000, 8, 1, 128),
                (1, 300, 4, 1, 256))
SSD_SHAPES = ((2, 64, 4, 16, 8, 16), (1, 128, 2, 32, 16, 32),
              (2, 64, 2, 8, 4, 64), (1, 96, 3, 16, 8, 32))
YI = (cs.LM_BATCH, cs.LM_PROMPT, 32, 4, 128)
# RecurrentGemma-2B's attention layers: MQA, head_dim 256, window 2048
RG = (cs.LM_BATCH, cs.LM_PROMPT, 10, 1, 256)
MAMBA = (cs.LM_BATCH, cs.LM_PROMPT, 32, 64, 128)


def per_call_ms(fn, calls: int = 10) -> dict:
    """Device ms per call of each port kernel that fn() launches."""
    fn()
    torch.cuda.synchronize()

    def many():
        for _ in range(calls):
            fn()
    rows = cs.profile_window(many, named=cs.PROFILE_NAMED)["named"]
    return {r["name"]: r["device_ms"] / calls for r in rows}


def main() -> int:
    cs.phase_device()
    cs.phase_build()
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    cases = []
    for B, S, Hq, Hkv, hd in (*FLASH_SHAPES, YI):
        for dtype in (torch.float32, torch.bfloat16):
            for window in ((0, 32) if S < 2048 else (0,)):
                cases.append((f"flash {dtype} {(B, S, Hq, Hkv, hd)} "
                              f"window {window}",
                              lambda a=(B, S, Hq, Hkv, hd, dtype, window):
                              cs._flash_case(*a, dev, gen)[1]))
    for window in (0, 2048):
        cases.append((f"flash bf16 {RG} window {window}",
                      lambda w=window: cs._flash_case(*RG, torch.bfloat16, w,
                                                      dev, gen)[1]))
    for shape in SSD_SHAPES:
        cases.append((f"ssd f32 {shape}", lambda s=shape: cs._ssd_case(
            *s, torch.float32, dev, gen)))
    for dtype in (torch.float32, torch.bfloat16):
        cases.append((f"ssd {dtype} {MAMBA}", lambda d=dtype: cs._ssd_case(
            *MAMBA, 256, d, dev, gen, full=True)))
    cases.append(("time flash_attention", lambda: cs._time_flash(dev)))
    cases.append(("time flash_attention hd 256", lambda: cs._time_flash(
        dev, RG, window=2048)))
    cases.append(("time ssd_scan", lambda: cs._time_ssd(dev)))
    bf = torch.bfloat16
    B, S, Hq, Hkv, hd = YI
    q, k, v = (torch.randn(B, S, h, hd, generator=gen, device=dev).to(bf)
               for h in (Hq, Hkv, Hkv))
    ssd_args = cs._ssd_inputs(*MAMBA, bf, dev, gen)
    cases.append(("profile flash_attention", lambda: per_call_ms(
        lambda: ops.flash_attention(q, k, v))))
    cases.append(("profile ssd_scan", lambda: per_call_ms(
        lambda: ops.ssd_scan(*ssd_args, chunk=256))))
    failed = 0
    for name, fn in cases:
        try:
            out = fn()
            torch.cuda.synchronize()
            print(json.dumps({"case": name, "ok": True, "result": out}),
                  flush=True)
        except Exception as e:  # report every case, then fail at the end
            failed += 1
            print(json.dumps({"case": name, "ok": False,
                              "error": repr(e)[:2000]}), flush=True)
    print(json.dumps({"cases": len(cases), "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
