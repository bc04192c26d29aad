"""Milliseconds a fleet iteration: the window's time over its ticks
times the slice length (host clock)."""


def read(ctx):
    return ctx.get("fleet_iter_ms")
