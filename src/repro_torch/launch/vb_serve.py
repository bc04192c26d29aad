"""VB serving launcher: a fleet of sensor-network sessions through
`serving.vb_service.VBService` (port of `repro.launch.vb_serve`).

    PYTHONPATH=src python -m repro_torch.launch.vb_serve \
        --sessions 2 --budgets 30,60 --nodes 8 --per-node 20 --slice 16 \
        [--device cpu]

Each session is an independent synthetic sensor network (the paper's
Sec. V-A generator with a different seed); `--budgets` gives the
per-session iteration budgets (cycled when shorter than `--sessions`:
heterogeneous budgets exercise the per-session gating), `--tol` enables
early stop, `--topology mixed` alternates diffusion and adaptive ADMM
fleets, `--push-at` demonstrates mid-flight data arrival, and
`--ckpt-dir` saves + restores + re-runs session 0 to demonstrate the
checkpoint path (asserting that the restored state equals the saved one
bit for bit).

Continuous batching (serving/driver.py): `--max-fleet` fixes the fleet
capacity (later arrivals queue until an eviction frees a slot, with no
reallocation) and `--arrive-at` staggers session admission to the given
slice boundaries (cycled), demonstrating mid-flight join.

Bucketed admission: `--per-node` and `--taus` take comma-separated lists
(cycled over sessions), so a MIXED fleet (several data shapes, several
Robbins-Monro taus) still lands in one fleet group per capacity rung;
`--bucket` selects the ladder ("pow2", a growth factor like 1.25, or
"none" for exact-shape grouping).  The run ends by printing the
`DriverStats` counters plus the per-bucket occupancy/padding breakdown.

Telemetry: `--trace OUT.json` and `--metrics OUT.prom` enable
`repro_torch.telemetry` for the run and, at drain, write a Chrome trace
(driver slices, first-stepped shapes, checkpoint writes, admission and
eviction markers, kernel calls) and the metrics snapshot in Prometheus
text format.

Runs on the CUDA card unless `--device cpu` is given.
"""
import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=2)
    ap.add_argument("--budgets", default="30,60",
                    help="comma-separated per-session iteration budgets")
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--per-node", default="20",
                    help="comma-separated per-node sample counts (cycled; "
                         "mixed values exercise bucketed admission)")
    ap.add_argument("--taus", default="",
                    help="comma-separated schedule taus (cycled over the "
                         "sessions whose topology has a natural-gradient "
                         "step; empty = the default tau)")
    ap.add_argument("--bucket", default="pow2",
                    help='admission ladder: "pow2", a growth factor '
                         '(e.g. 1.25), or "none"')
    ap.add_argument("--slice", type=int, default=16)
    ap.add_argument("--tol", type=float, default=0.0)
    ap.add_argument("--topology", default="mixed",
                    choices=["diffusion", "admm", "ring", "mixed"])
    ap.add_argument("--minibatch", type=int, default=0,
                    help="streaming minibatch size (0 = full batch)")
    ap.add_argument("--push-at", type=int, default=0,
                    help="after this many slices, append 1 fresh point "
                         "to node 0 of session 0 (0 = off)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="save/restore session 0 through this directory "
                         "and assert the restored state is bit-exact")
    ap.add_argument("--max-fleet", type=int, default=0,
                    help="fixed fleet capacity (continuous batching; "
                         "0 = power-of-two auto-growth)")
    ap.add_argument("--arrive-at", default="",
                    help="comma-separated slice boundaries at which each "
                         "session joins (cycled; empty = all at once)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="enable telemetry and dump a Chrome trace "
                         "(chrome://tracing / Perfetto) of the run — "
                         "driver slices, compiles, checkpoint writes, "
                         "admission/eviction markers — at drain")
    ap.add_argument("--metrics", default=None, metavar="OUT.prom",
                    help="enable telemetry and dump the metrics "
                         "snapshot (Prometheus text format) at drain")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    if not (args.trace or args.metrics):
        _serve(args)
        return
    from repro_torch import telemetry
    with telemetry.enabled_scope():
        _serve(args)
    if args.trace:
        telemetry.export_chrome_trace(args.trace)
        names = ", ".join(telemetry.tracer().span_names())
        print(f"telemetry: wrote {len(telemetry.tracer())} trace events "
              f"to {args.trace} ({names})")
    if args.metrics:
        with open(args.metrics, "w") as f:
            f.write(telemetry.to_prometheus())
        print(f"telemetry: wrote {len(telemetry.registry())} metric "
              f"series to {args.metrics}")


def _serve(args) -> None:
    import numpy as np
    import torch

    from repro_torch.core import engine, expfam, network
    from repro_torch.core import model as model_lib
    from repro_torch.data import stream, synthetic
    from repro_torch.device import resolve
    from repro_torch.serving.vb_service import VBRequest, VBService

    dev = resolve(args.device)
    K, D = 3, 2
    prior = expfam.noninformative_prior(K, D, beta0=0.1, w0_scale=10.0,
                                        device=dev)
    adj, _ = network.random_geometric_graph(args.nodes, seed=0)
    W = network.nearest_neighbor_weights(adj)
    mdl = model_lib.GMMModel(prior, K, D, device=dev)
    topos = {"diffusion": engine.Diffusion(W),
             "admm": engine.ADMMConsensus(adj, adaptive_rho=True),
             "ring": engine.RingDiffusion()}
    order = (["diffusion", "admm"] if args.topology == "mixed"
             else [args.topology])
    budgets = [int(b) for b in args.budgets.split(",")]
    minibatch = (stream.MinibatchSpec(args.minibatch)
                 if args.minibatch else None)

    arrivals = ([int(a) for a in args.arrive_at.split(",")]
                if args.arrive_at else [None])
    per_node = [int(p) for p in args.per_node.split(",")]
    taus = [float(t) for t in args.taus.split(",")] if args.taus else []
    bucket = (None if args.bucket == "none"
              else "pow2" if args.bucket == "pow2" else float(args.bucket))

    svc = VBService(slice_iters=args.slice,
                    max_fleet=args.max_fleet or None, bucket=bucket,
                    device=dev)
    requests = {}
    for i in range(args.sessions):
        data = synthetic.paper_synthetic(
            n_nodes=args.nodes, n_per_node=per_node[i % len(per_node)],
            seed=i)
        # leave one free slot per node so --push-at has capacity
        mask = data.mask.clone()
        mask[:, -1] = 0.0
        topo = topos[order[i % len(order)]]
        sched = engine.Schedule()
        if taus and getattr(topo, "uses_schedule", True):
            sched = engine.Schedule(tau=taus[i % len(taus)])
        req = VBRequest(model=mdl, data=(data.x, mask),
                        topology=topo, schedule=sched,
                        n_iters=budgets[i % len(budgets)],
                        minibatch=minibatch, tol=args.tol)
        rid = svc.submit(req, arrive_at=arrivals[i % len(arrivals)])
        requests[rid] = req

    pushed = False
    n_slices = 0
    while True:
        left = svc.step_slice()
        n_slices += 1
        if args.push_at and n_slices == args.push_at and not pushed:
            rid0 = svc.sessions[0]
            rng = np.random.default_rng(123)
            svc.push_data(rid0, node=0, points=rng.normal(size=(1, D)))
            pushed = True
            print(f"[slice {n_slices}] pushed 1 fresh point to "
                  f"{rid0} node 0")
        if left == 0:
            break

    print(f"{'session':9s} {'topology':22s} {'iters':>6s} {'budget':>7s} "
          f"{'conv':>5s} {'final delta':>12s}")
    for rid in svc.sessions:
        st = svc.status(rid)
        topo = type(requests[rid].topology).__name__
        print(f"{rid:9s} {topo:22s} {st.t:6d} {st.budget:7d} "
              f"{str(st.converged):>5s} {st.delta:12.3e}")

    if args.ckpt_dir:
        rid0 = svc.sessions[0]
        os.makedirs(args.ckpt_dir, exist_ok=True)
        path = os.path.join(args.ckpt_dir, f"{rid0}.npz")
        svc.save_session(rid0, path)
        # resume into a FRESH service and extend the budget a little
        svc2 = VBService(slice_iters=args.slice, device=dev)
        rid_r = svc2.submit(requests[rid0], restore_from=path)
        st0, st_r = svc.status(rid0), svc2.status(rid_r)
        assert st_r.t == st0.t, (st_r.t, st0.t)
        assert torch.equal(st0.phi, st_r.phi)
        svc2.extend_budget(rid_r, args.slice)
        svc2.run()
        print(f"checkpoint: saved {rid0} at t={st0.t} -> {path}, "
              f"restored bit-exact, extended to "
              f"t={svc2.status(rid_r).t}")

    st = svc.stats()
    print(f"driver: {st.slices} slices, {st.compiles} compiles, "
          f"{st.admitted} admitted, {st.evicted} evicted, "
          f"occupancy {st.occupancy:.2f} "
          f"(padding waste {st.padding_waste:.2f}), "
          f"{st.checkpoints} background checkpoints")
    for b in st.buckets:
        print(f"  bucket {b.label}: {b.admitted} admitted over "
              f"{b.slots} slot(s), occupancy {b.occupancy:.2f}, "
              f"data padding {b.data_pad_frac:.2f}")
    print(f"served {args.sessions} session(s) in {n_slices} slice(s)")


if __name__ == "__main__":
    main()
