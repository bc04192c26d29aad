"""The LM sharding's card phases alone, and where the serving engines'
memory goes.

    python3 tools/lm_mesh_check.py            # the phases
    python3 tools/lm_mesh_check.py --memory   # allocator peaks (~1 min)
    python3 tools/lm_mesh_check.py --dryrun   # the dry run's phase

Run on a machine with the card, from the repository root.  Without
`--memory` it runs `chip_smoke.py`'s `lm_mesh_serve_{yi_6b,mamba2_370m}`
and `lm_mesh_train` phases on a (1, 1) mesh over a one-rank NCCL group
and prints their JSON lines.  With `--memory` it serves Yi-6B and
Mamba-2 370M at published width cut to 4 layers (4 x 2048-token
prompts, 4 new tokens), once through the unsharded `Engine` and once
through `Engine(mesh=)`, and prints for each the transient peak of the
generate call and the allocations live at that peak by source line
(`chip_smoke._peak_sites`, from the allocator's history).  With
`--dryrun` it starts the dry run's worker (`chip_smoke.start_dryrun`),
serves Yi-6B through both engines with the mesh engine's prefill counted,
and runs `launch_dryrun` against it.
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import model as lm_model  # noqa: E402
from repro_torch.serving import engine  # noqa: E402


def memory(dev, mesh) -> None:
    for arch in ("yi_6b", "mamba2_370m"):
        cfg = get_config(arch).replace(n_layers=4)
        lm = lm_model.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                  device=dev)
        reqs = cs._requests(cfg, 4)
        for name, m in (("plain", None), ("mesh", mesh)):
            eng = engine.Engine(cfg, lm, max_seq=cs.LM_PROMPT + 4,
                                use_kernels=True, device=dev, mesh=m)
            eng.generate([engine.Request(r.prompt[:64], 2) for r in reqs])
            out = cs._peak_sites(lambda: eng.generate(reqs), top=10)
            print(json.dumps({"arch": arch, "layers": 4, "engine": name,
                              **out}), flush=True)


def main():
    cs.phase_device()
    dev = torch.device("cuda")
    mesh = mesh_lib.make_test_mesh(1, 1, device=dev)
    if "--memory" in sys.argv[1:]:
        memory(dev, mesh)
    elif "--dryrun" in sys.argv[1:]:
        dry = cs.start_dryrun()
        try:
            served = cs.phase_lm_mesh_serve("yi_6b", dev, mesh,
                                            count_prefill=True)["mesh"]
            cs.phase_launch_dryrun(dry, served)
        finally:
            if dry.poll() is None:
                dry.kill()
                dry.wait()
    else:
        for arch in ("yi_6b", "mamba2_370m"):
            cs.phase_lm_mesh_serve(arch, dev, mesh)
        cs.phase_lm_mesh_train(dev, mesh, mesh_lib.data_mesh(device=dev))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
