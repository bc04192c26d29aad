"""Host milliseconds a fleet iteration spends admitting and evicting
sessions: the program's `driver/admit` (the slot write) and
`driver/evict` (the state snapshot) spans in the traced window over its
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
    rows = [summary().get(n) for n in ("driver/admit", "driver/evict")]
    if not any(rows):
        return None
    return sum(r[1] for r in rows if r) / 1e3 / iters
