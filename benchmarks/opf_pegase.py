"""case1354pegase AC OPF on the GPU, with the f64 endgame solve timed alone.

The f32 factorization's backward error walls the interior-point endgame at
pegase scale; the IPM then switches to the full-f64 LU
(ops/linalg.py solve_f64_sqd). The reference's bar is a converged Ipopt
solve (acOptimalPowerFlow.jl:333, analysis.jl:9-12).

Phase 1 times one f64 LU factorize+solve at the actual KKT size on the
device, so a pathological rate aborts before the full solve. Phase 2 runs
the full OPF with verbose=2 so the endgame switch and per-iteration walls
land in the log.

Usage: python benchmarks/opf_pegase.py [--cpu] [--max-seconds 1500]
       [--skip-probe] [--capture <file>.npz]
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
    ap.add_argument("--max-seconds", type=float, default=1500.0)
    ap.add_argument("--max-iter", type=int, default=200)
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--verbose", type=int, default=2)
    ap.add_argument("--skip-probe", action="store_true")
    ap.add_argument("--probe-abort-s", type=float, default=120.0)
    ap.add_argument("--capture", default="")
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    import jax
    import jax.numpy as jnp
    import numpy as np

    import juliagrid_tpu as jg
    from juliagrid_tpu.opf.acopf import ac_optimal_power_flow
    from juliagrid_tpu.opf.acopf import solve as ac_solve
    from juliagrid_tpu.ops import linalg

    out = {"device": str(jax.devices()[0])}
    print(json.dumps({"phase": "init", **out}), flush=True)

    data = os.path.join(ROOT, "tests", "data", "case1354pegase.npz")
    system = jg.power_system(data)
    analysis = ac_optimal_power_flow(system)
    analysis._refresh_spec()
    spec = analysis._spec
    n_aug = spec.n_x + spec.m_e
    out.update(buses=system.bus.number, n_x=spec.n_x, m_e=spec.m_e,
               m_i=spec.m_i, n_aug=n_aug)

    if not args.skip_probe:
        # Phase 1: f64 LU throughput at the real KKT size
        rng = np.random.default_rng(0)
        h = rng.standard_normal((n_aug, n_aug)) / np.sqrt(n_aug)
        a = h @ h.T + np.eye(n_aug)
        a[spec.n_x:, spec.n_x:] *= -1.0  # SQD sign pattern
        a = (a + a.T) / 2.0
        b = rng.standard_normal(n_aug)
        aj = jnp.asarray(a)
        bj = jnp.asarray(b)
        f = jax.jit(lambda aa, bb: linalg.solve_f64_sqd(aa, bb, refine=1))
        t0 = time.perf_counter()
        x = f(aj, bj)
        x.block_until_ready()
        compile_and_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        x = f(aj, bj)
        x.block_until_ready()
        warm = time.perf_counter() - t0
        flops = 2.0 * n_aug ** 3 / 3.0
        out["f64_lu_probe"] = {
            "n": n_aug, "compile_plus_first_s": round(compile_and_first, 1),
            "warm_s": round(warm, 2),
            "effective_f64_tflops": round(flops / warm / 1e12, 3)}
        print(json.dumps({"phase": "probe", **out}), flush=True)
        if warm > args.probe_abort_s:
            out["aborted"] = f"f64 LU warm {warm:.0f}s > {args.probe_abort_s}s"
            print(json.dumps({"phase": "final", **out}), flush=True)
            return

    # Phase 2: the full solve
    t0 = time.perf_counter()
    ac_solve(analysis, max_iter=args.max_iter, tolerance=args.tol,
             verbose=args.verbose, max_seconds=args.max_seconds)
    wall = time.perf_counter() - t0
    res = analysis.method.result
    out.update(
        opf_status=res.status, opf_converged=bool(res.converged),
        opf_iterations=int(res.iterations),
        opf_objective=round(float(res.objective), 4),
        opf_kkt_error=float(res.kkt_error),
        opf_wall_s=round(wall, 1))
    if args.capture:
        np.savez(args.capture, x=res.x, y=res.y, z=res.z, s=res.s)
        out["capture"] = args.capture
    print(json.dumps({"phase": "final", **out}), flush=True)


if __name__ == "__main__":
    main()
