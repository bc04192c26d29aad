"""Which batch sizes the card's batched `torch.linalg.eigh` takes.

    python3 tools/eigh_batch_probe.py

On a CUDA card: `torch.linalg.eigh` on (b, 2, 2) and (b, 3, 3) f64
symmetric positive definite batches for b from 1,000 to 300,000, with
the default linear-algebra library (cuSOLVER) and with MAGMA.  Prints a
JSON object {"<library>_<b>" or "<library>_3x3_<b>": "ok" or "fail
<message>"}; then, with the default library, the device memory one call
allocates beyond its input and output ("workspace_<b>", bytes) and, for
300,000 2x2 matrices (100,000 sensors x K=3) split into chunks of c, the
ms of the whole batch and the largest allocation above the input
("chunks_<c>": [ms, bytes]); and the torch and CUDA versions.  The
Normal-Wishart projection (core/expfam.py::nw_project) chunks its eigh
at `EIGH_MAX_BATCH`: below the smallest failing batch, and sized by the
workspace it costs.
"""
import json

import torch


def probe(lib: str, b: int, n: int) -> str:
    dev = torch.device("cuda")
    a = torch.rand(b, n, n, dtype=torch.float64, device=dev)
    a = a @ a.transpose(-1, -2) + torch.eye(n, dtype=torch.float64,
                                            device=dev)
    try:
        torch.linalg.eigh(a)
        torch.cuda.synchronize()
        return "ok"
    except RuntimeError as e:
        return "fail " + str(e)[:60]


def _spd(b: int, n: int) -> torch.Tensor:
    a = torch.rand(b, n, n, dtype=torch.float64, device="cuda")
    return a @ a.transpose(-1, -2) + torch.eye(n, dtype=torch.float64,
                                               device="cuda")


def workspace(b: int) -> int:
    """Bytes one eigh call on b 2x2 matrices holds beyond its input and
    its output at its peak."""
    a = _spd(b, 2)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    w, v = torch.linalg.eigh(a)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base - w.nbytes - v.nbytes


def chunked(b: int, c: int, reps: int = 5) -> list:
    """[ms, peak bytes above the input] of eigh over b 2x2 matrices in
    chunks of c, as core/expfam.py::_eigh splits them."""
    a = _spd(b, 2)
    run = lambda: [torch.linalg.eigh(x) for x in a.split(c)]  # noqa: E731
    run()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) / reps,
            torch.cuda.max_memory_allocated() - base]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("eigh_batch_probe: needs a CUDA card")
    out = {}
    for b in (1024, 4096, 16384):
        out[f"workspace_{b}"] = workspace(b)
    for c in (2048, 4096, 8192, 16384):
        out[f"chunks_{c}"] = chunked(300_000, c)
    for lib in ("default", "magma"):
        if lib == "magma":
            torch.backends.cuda.preferred_linalg_library("magma")
        for b in (1000, 3000, 16384, 30000, 32766, 32767, 65536, 300000):
            out[f"{lib}_{b}"] = probe(lib, b, 2)
        for b in (30000, 32768, 300000):
            out[f"{lib}_3x3_{b}"] = probe(lib, b, 3)
    print(json.dumps(out, indent=0))
    print(torch.__version__, torch.version.cuda)


if __name__ == "__main__":
    main()
