"""Device milliseconds a (fleet) iteration outside the gmm_estep kernels
(profiler): the engine's post-stage, combine and bookkeeping on the
device."""

from vbbench.harness import kernel_seconds


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["n_kernels"] or not ctx.get("iterations"):
        return None
    _, estep_s = kernel_seconds(tr, "gmm_estep")
    return (tr["busy_s"] - estep_s) * 1e3 / ctx["iterations"]
