"""Device kernels a (fleet) iteration in the traced window (profiler):
the engine's launch count, which host time per iteration follows."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["n_kernels"] or not ctx.get("iterations"):
        return None
    return tr["n_kernels"] / ctx["iterations"]
