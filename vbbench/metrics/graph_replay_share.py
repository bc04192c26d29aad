"""Share of the traced window's fleet iterations, in %, that ran as a
replay of the fleet's captured CUDA graph rather than op by op from
Python: the program's `driver_graph_replays_total` over its
`driver_fleet_iterations_total` (both recorded while a profiler does;
an eager slice adds 0 replays).  None where the program keeps no such
counter."""


def read(ctx):
    from repro_torch import telemetry

    rows = telemetry.snapshot()
    iters = sum(r["value"] for r in rows
                if r["name"] == "driver_fleet_iterations_total")
    replays = [r["value"] for r in rows
               if r["name"] == "driver_graph_replays_total"]
    if not iters or not replays:
        return None
    return 100.0 * sum(replays) / iters
