"""ACTIVSg10k on the JAX/BBD solve path — the capability-envelope proof.

Runs the full 10,000-bus case end-to-end on whatever device JAX offers
(the GPU; the CPU with --cpu):

  1. Newton-Raphson power flow on the BBD/Schur substrate (k blocks),
  2. Gauss-Newton WLS state estimation on the SE-BBD substrate from a
     zero-noise SCADA+PMU set built off the solved flow (the reference's
     estimator-reproduces-PF invariant, test/stateEstimation/analysis.jl
     pattern, at 74x the reference test-case size),
  3. the dense->BBD crossover table (dense SE vs BBD SE wall time at
     118 / 1354 / 1951 buses, BBD-only at 10k where dense cannot run).

Prints one JSON document.

Usage:  python benchmarks/scale_10k.py [--cpu] [--skip-crossover]
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
DATA = os.path.join(ROOT, "tests", "data")
sys.path.insert(0, ROOT)


def _scada_pmu(system, pf, pmu_every=10):
    from juliagrid_tpu.measurement.devices import (add_pmu, add_varmeter,
                                                   add_voltmeter,
                                                   add_wattmeter)
    from juliagrid_tpu.measurement.load import measurement

    mon = measurement(system)
    add_voltmeter(mon, analysis=pf, noise=False)
    add_wattmeter(mon, analysis=pf, noise=False)
    add_varmeter(mon, analysis=pf, noise=False)
    for b in range(0, system.bus.number, pmu_every):
        add_pmu(mon, bus=system.bus.label.label(b),
                magnitude=float(pf.voltage.magnitude[b]),
                angle=float(pf.voltage.angle[b]), polar=True, noise=False)
    return mon


def run_10k(n_blocks=16):
    import numpy as np

    import juliagrid_tpu as jg
    from juliagrid_tpu.estimation.acse_bbd import (gauss_newton_bbd,
                                                   se_bbd_solve)
    from juliagrid_tpu.postprocessing.ac import power
    from juliagrid_tpu.powerflow.newton_bbd import (newton_raphson_bbd,
                                                    power_flow_bbd)

    out = {}
    system = jg.power_system(os.path.join(DATA, "case_ACTIVSg10k.npz"))
    out["buses"] = system.bus.number
    out["branches"] = system.branch.number

    # --- NR on BBD ---------------------------------------------------
    pf = newton_raphson_bbd(system, n_blocks=n_blocks)
    t0 = time.perf_counter()
    power_flow_bbd(pf)
    t_compile_plus = time.perf_counter() - t0
    pf2 = newton_raphson_bbd(system, n_blocks=n_blocks)
    t0 = time.perf_counter()
    power_flow_bbd(pf2)
    t_warm = time.perf_counter() - t0
    out["nr_bbd"] = {
        "blocks": n_blocks,
        "converged": bool(pf.method.converged),
        "iterations": int(pf.method.iteration),
        "max_mismatch": max(float(pf.method.max_mismatch_active),
                            float(pf.method.max_mismatch_reactive)),
        "wall_first_s": round(t_compile_plus, 2),
        "wall_warm_s": round(t_warm, 3),
    }
    if not pf.method.converged:
        return out

    # --- SE on BBD (zero-noise SCADA+PMU reproduces the PF state) -----
    try:
        _run_10k_se(out, system, pf, n_blocks)
    except Exception as exc:
        out["se_bbd"] = {"error": f"{type(exc).__name__}: {str(exc)[:300]}"}
    return out


def _run_10k_se(out, system, pf, n_blocks):
    import numpy as np

    from juliagrid_tpu.estimation.acse_bbd import (gauss_newton_bbd,
                                                   se_bbd_solve)
    from juliagrid_tpu.postprocessing.ac import power

    power(pf)
    mon = _scada_pmu(system, pf)
    t0 = time.perf_counter()
    se = gauss_newton_bbd(mon, n_blocks=n_blocks)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    se_bbd_solve(se)
    t_first = time.perf_counter() - t0
    se2 = gauss_newton_bbd(mon, n_blocks=n_blocks)
    t0 = time.perf_counter()
    se_bbd_solve(se2)
    t_warm = time.perf_counter() - t0
    err_vm = float(np.max(np.abs(se.voltage.magnitude
                                 - pf.voltage.magnitude)))
    err_va = float(np.max(np.abs(se.voltage.angle - pf.voltage.angle)))
    out["se_bbd"] = {
        "blocks": n_blocks,
        "rows": len(se.method.row_device),
        "states": 2 * system.bus.number,
        "converged": bool(se.method.converged),
        "iterations": int(se.method.iteration),
        "build_s": round(t_build, 2),
        "wall_first_s": round(t_first, 2),
        "wall_warm_s": round(t_warm, 3),
        "max_err_vs_pf_vm": err_vm,
        "max_err_vs_pf_va": err_va,
    }


def crossover():
    """Dense vs BBD SE wall time by case size (warm solves)."""
    import numpy as np

    import juliagrid_tpu as jg
    from juliagrid_tpu.estimation.acse import gauss_newton, state_estimation
    from juliagrid_tpu.estimation.acse_bbd import (gauss_newton_bbd,
                                                   se_bbd_solve)
    from juliagrid_tpu.powerflow.ac import newton_raphson
    from juliagrid_tpu.powerflow.driver import power_flow

    rows = []
    for case, blocks in [("case118.m", 4), ("case1354pegase.npz", 8),
                         ("case1951rte.npz", 8)]:
        system = jg.power_system(os.path.join(DATA, case))
        pf = newton_raphson(system)
        power_flow(pf, power=True)
        mon = _scada_pmu(system, pf)

        se = gauss_newton(mon)
        state_estimation(se)          # compile + solve
        se_d = gauss_newton(mon)
        t0 = time.perf_counter()
        state_estimation(se_d)
        t_dense = time.perf_counter() - t0

        bb = gauss_newton_bbd(mon, n_blocks=blocks)
        se_bbd_solve(bb)
        bb2 = gauss_newton_bbd(mon, n_blocks=blocks)
        t0 = time.perf_counter()
        se_bbd_solve(bb2)
        t_bbd = time.perf_counter() - t0

        equal = bool(
            np.max(np.abs(bb.voltage.magnitude - se.voltage.magnitude))
            < 1e-8)
        rows.append({
            "case": case, "buses": system.bus.number, "blocks": blocks,
            "dense_warm_s": round(t_dense, 3),
            "bbd_warm_s": round(t_bbd, 3),
            "bbd_matches_dense": equal,
            "dense_iterations": int(se.method.iteration),
            "bbd_iterations": int(bb.method.iteration),
        })
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--skip-crossover", action="store_true")
    ap.add_argument("--blocks", type=int, default=16)
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    result = {"device": str(jax.devices()[0])}
    result["activsg10k"] = run_10k(n_blocks=args.blocks)
    if not args.skip_crossover:
        result["crossover"] = crossover()
    print(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
