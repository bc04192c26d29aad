"""The E-step kernel's share of its roofline, in %: the frozen count's
least time of one `gmm_estep_nodes` call (counts/gmm_work.py) times the
calls in the traced window (the program's launch counter), over the
device time of the kernels named gmm_estep in the trace.  Nothing to
read when no such kernel ran."""

from vbbench.harness import kernel_seconds


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not ctx.get("estep_calls"):
        return None
    calls, secs = kernel_seconds(tr, "gmm_estep")
    if not calls or secs <= 0.0:
        return None
    return 100.0 * ctx["estep_least_s"] * ctx["estep_calls"] / secs
