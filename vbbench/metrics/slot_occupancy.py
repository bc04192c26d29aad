"""The fleet slots that held an active session, in % of the slots
stepped, over the window's slices (the driver's DriverStats occupancy
and slice count, before and after the window)."""


def read(ctx):
    occ = ctx.get("occupancy")
    return None if occ is None else 100.0 * occ
