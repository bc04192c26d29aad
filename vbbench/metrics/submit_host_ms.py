"""Host milliseconds a fleet iteration spends in `VBDriver.submit` itself
(`vb_init`, the bucket plan, the session's record; the admissions it
makes are its child spans and left out): the self time of the program's
`driver/submit` spans in the traced window over its
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
    row = summary().get("driver/submit")
    return None if row is None else row[2] / 1e3 / iters
