"""Host milliseconds a fleet iteration spends queueing the slice's
kernels: the program's `driver/slice` spans in the traced window (its
tracer records while a profiler does) over its
`driver_fleet_iterations_total`.  Host time under the profiler: compare
it from one version to the next, never with an untraced time.  None
where the program keeps no such span or counter."""


def read(ctx):
    from repro_torch import telemetry

    iters = sum(r["value"] for r in telemetry.snapshot()
                if r["name"] == "driver_fleet_iterations_total")
    summary = getattr(telemetry.tracer(), "summary", None)
    if not iters or summary is None:
        return None
    row = summary().get("driver/slice")
    return None if row is None else row[1] / 1e3 / iters
