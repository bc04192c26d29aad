"""repro_torch.optim — AdamW, the learning-rate schedules and the
consensus layer (diffusion and ADMM over the mesh executor)."""
from repro_torch.optim import adamw, consensus, schedules  # noqa: F401
