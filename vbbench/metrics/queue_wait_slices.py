"""Slice boundaries a session waited in the driver's queue for a fleet
slot, the mean over the sessions admitted in the traced window: the
program's `driver_queue_wait_slices` histogram (sum over count), which
the driver observes at each admission while a profiler records.  It
counts slice boundaries, so the profiler's slowdown does not move it.
None where the program keeps no such histogram."""


def read(ctx):
    from repro_torch import telemetry

    for row in telemetry.snapshot():
        if row["name"] == "driver_queue_wait_slices" and row["count"]:
            return row["sum"] / row["count"]
    return None
