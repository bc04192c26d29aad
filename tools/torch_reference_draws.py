"""Write the JAX reference's initial-posterior draws for the PyTorch port.

    PYTHONPATH=src python tools/torch_reference_draws.py

The Sec. V figures start every estimator from
`algorithms._perturbed_init(prior, x, jax.random.PRNGKey(seed))`, whose
means are lo + (hi - lo) u for u = jax.random.uniform(key, (K, D),
float64).  torch cannot reproduce `jax.random`, so the port's figures
(`src/repro_torch/experiments/paper_figures.py`) read these u from
`src/repro_torch/experiments/reference_draws.npz`, which this script
writes: one array per (seed, K, D) the figures use, at their default
(reduced) and `--full` sizes.  It runs on the CPU and is the only part of
the port's tooling that imports JAX; `tests/test_torch_paper_sec5.py`
regenerates the draws and checks that the committed file equals them.
"""
from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, os.pardir, "src", "repro_torch", "experiments",
                   "reference_draws.npz")

#: (seed, K, D) of every setup_gmm call in the Sec. V figures: figs. 3-10
#: (K=3, D=2), Table I (2, 3), Table II (2, 34), Fig. 13 (K = 2, 4, 6 at
#: D = 52; 8 and 10 with --full)
SHAPES = [(0, 3, 2), (0, 2, 3), (0, 2, 34), (0, 2, 52), (0, 4, 52),
          (0, 6, 52), (0, 8, 52), (0, 10, 52)]


def draws() -> dict:
    """{key: u} with the port's key names (common.draw_key)."""
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    return {f"seed{seed}_K{K}_D{D}": np.asarray(jax.random.uniform(
        jax.random.PRNGKey(seed), (K, D), jnp.float64))
        for seed, K, D in SHAPES}


def main():
    np.savez(OUT, **draws())
    print(f"wrote {len(SHAPES)} draws to {os.path.normpath(OUT)}")


if __name__ == "__main__":
    sys.exit(main())
