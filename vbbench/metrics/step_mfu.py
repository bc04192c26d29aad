"""The whole (fleet) iteration's share of the card's peak, in %: its
least time at the published peaks (inputs read once, outputs written
once, the E-step's operations; counts/gmm_work.py) over the time an
iteration takes in the run's untraced window (host clock), which the
profiler does not lengthen.  It bounds a gain wherever the kernels
go."""


def read(ctx):
    if not ctx.get("iter_least_s") or not ctx.get("iter_s"):
        return None
    return 100.0 * ctx["iter_least_s"] / ctx["iter_s"]
