"""PyTorch/CUDA port of the distributed variational Bayes engine.

A second package beside the JAX reference `repro`: the same modules under
the same names (`repro_torch.core.expfam`, `repro_torch.kernels.gmm_estep`,
...), written as plain functions on tensors.  It imports neither `jax` nor
anything of `repro`.

Entry points (`core.engine.run_vb` / `vb_init`, `core.algorithms.run_*`,
`core.model.GMMModel`) run on the CUDA device unless the caller passes
`device="cpu"`; see `repro_torch.device.resolve`.
"""
