"""AC OPF capability envelope on the structured BBD KKT path.

The reference solves pegase-class OPF NLPs through Ipopt's sparse MA27
factorization (acOptimalPowerFlow.jl:333) and ships datasets to
ACTIVSg25k/70k (docs/src/examples/powerSystemDatasets.md:5-18). The
repo's dense IPM KKT is used below ~4k buses; this proof runs the structured
BBD KKT (opf/kkt_bbd.py) on a synthetic lattice with quadratic costs and
voltage bounds (utils/synthetic.py opf=True) at 10k-class size.

Prints one JSON document per phase.

Usage:  python benchmarks/opf_scale.py [--cpu] [--rows 100] [--cols 100]
        [--blocks 0=auto] [--max-seconds 1500] [--tol 1e-6]
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--rows", type=int, default=100)
    ap.add_argument("--cols", type=int, default=100)
    ap.add_argument("--blocks", type=int, default=0)
    ap.add_argument("--max-seconds", type=float, default=1500.0)
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--max-iter", type=int, default=120)
    ap.add_argument("--verbose", type=int, default=1)
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from juliagrid_tpu.opf.acopf import ac_optimal_power_flow
    from juliagrid_tpu.opf.acopf import solve as ac_solve
    from juliagrid_tpu.utils.synthetic import synthetic_grid

    out = {}
    t0 = time.perf_counter()
    system = synthetic_grid(args.rows, args.cols, opf=True)
    out["build_s"] = round(time.perf_counter() - t0, 1)
    out["buses"] = system.bus.number
    out["branches"] = system.branch.number
    out["generators"] = system.generator.number

    t0 = time.perf_counter()
    analysis = ac_optimal_power_flow(system)
    analysis._refresh_spec()
    spec = analysis._spec
    out["setup_s"] = round(time.perf_counter() - t0, 1)
    out["n_x"] = spec.n_x
    out["m_e"] = spec.m_e
    out["m_i"] = spec.m_i
    print(json.dumps({"model": out}), flush=True)

    blocks = args.blocks if args.blocks else None
    t0 = time.perf_counter()
    ac_solve(analysis, kkt_blocks=blocks, tolerance=args.tol,
             max_iter=args.max_iter, max_seconds=args.max_seconds,
             verbose=args.verbose)
    out["solve_first_s"] = round(time.perf_counter() - t0, 1)
    res = analysis.method.result
    out["status"] = res.status
    out["iterations"] = res.iterations
    out["kkt_error"] = float(res.kkt_error)
    out["objective"] = float(res.objective)
    if hasattr(analysis, "_kkt_cache"):
        k = analysis._kkt_cache[1]
        out["kkt_blocks"] = k.k
        out["kkt_block_size"] = k.ni
        out["kkt_border"] = k.mb
        out["kkt_entries"] = int(k.n_entries)
    print(json.dumps(out), flush=True)

    # warm re-solve after a LIVE numeric cost edit: same routed KKT
    # structure, XLA compile-cache hit, dual carry armed by the edit
    from juliagrid_tpu.opf.edit import update_cost
    update_cost(analysis, 1, active=2, polynomial=[0.05, 25.0, 0.0])
    t0 = time.perf_counter()
    ac_solve(analysis, kkt_blocks=blocks, tolerance=args.tol,
             max_iter=args.max_iter, max_seconds=args.max_seconds,
             verbose=args.verbose)
    out["solve_warm_s"] = round(time.perf_counter() - t0, 1)
    out["warm_status"] = analysis.method.result.status
    out["warm_iterations"] = analysis.method.result.iterations
    print(json.dumps(out))


if __name__ == "__main__":
    main()
