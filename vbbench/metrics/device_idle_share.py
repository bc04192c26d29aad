"""The share of an iteration, in %, in which no operation ran on the
device: 1 less the device-busy seconds an iteration of the traced
window (the union of the profiler's device intervals) over the seconds
an iteration takes in the run's untraced window (host clock), so the
profiler's host overhead, which lengthens the traced window, does not
count as idle."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["n_kernels"] or not ctx.get("iterations") \
            or not ctx.get("iter_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / ctx["iterations"] / ctx["iter_s"])
