"""25,000-bus capability envelope on the JAX/BBD solve path.

The reference's dataset envelope runs to ACTIVSg25k/70k/SyntheticUSA
(docs/src/examples/powerSystemDatasets.md:5-18); those fixtures are not
redistributable here, so this proof runs a 158x158 synthetic lattice with
an EHV backbone (utils/synthetic.py — 24,964 buses, ~49.6k branches),
2.5x the largest shipped fixture:

  1. Newton-Raphson power flow on the BBD/Schur substrate,
  2. zero-noise GN WLS SE on the SE-BBD substrate (estimator-reproduces-
     PF invariant at ~125k measurement rows / ~50k states).

Prints one JSON document.

Usage:  python benchmarks/scale_25k.py [--cpu] [--rows 158] [--cols 158]
        [--blocks 32]
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
    ap.add_argument("--rows", type=int, default=158)
    ap.add_argument("--cols", type=int, default=158)
    ap.add_argument("--blocks", type=int, default=32)
    ap.add_argument("--skip-se", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    import juliagrid_tpu as jg
    from juliagrid_tpu.utils.synthetic import synthetic_grid
    from juliagrid_tpu.powerflow.newton_bbd import (newton_raphson_bbd,
                                                    power_flow_bbd)

    out = {}
    t0 = time.perf_counter()
    system = synthetic_grid(args.rows, args.cols)
    out["build_s"] = round(time.perf_counter() - t0, 1)
    out["buses"] = system.bus.number
    out["branches"] = system.branch.number
    print(json.dumps({"phase": "built", **out}), flush=True)

    t0 = time.perf_counter()
    pf = newton_raphson_bbd(system, n_blocks=args.blocks)
    out["nr_setup_s"] = round(time.perf_counter() - t0, 1)
    lay = pf._bbd_layout
    out["bbd"] = {"k": lay.k, "ni": lay.ni, "mb": lay.mb, "mbl": lay.mbl}
    print(json.dumps({"phase": "routed", **out}), flush=True)

    t0 = time.perf_counter()
    power_flow_bbd(pf, iteration=40)
    out["nr_first_s"] = round(time.perf_counter() - t0, 1)
    out["nr_iterations"] = int(pf.method.iteration)
    out["nr_converged"] = bool(pf.method.converged)
    print(json.dumps({"nr": out}), flush=True)

    # warm re-solve (flat restart, same compiled program)
    n = system.bus.number
    system.bus.voltage.magnitude.array[:n] = 1.0
    system.bus.voltage.angle.array[:n] = 0.0
    pf2 = newton_raphson_bbd(system, n_blocks=args.blocks)
    t0 = time.perf_counter()
    power_flow_bbd(pf2, iteration=40)
    out["nr_warm_s"] = round(time.perf_counter() - t0, 2)
    assert pf2.method.converged

    if not args.skip_se:
        from juliagrid_tpu.estimation.acse_bbd import (gauss_newton_bbd,
                                                       se_bbd_solve)
        from juliagrid_tpu.measurement.devices import (add_varmeter,
                                                       add_voltmeter,
                                                       add_wattmeter)
        from juliagrid_tpu.measurement.load import measurement

        from juliagrid_tpu.postprocessing.ac import power as ac_power
        ac_power(pf2)
        mon = measurement(system)
        add_voltmeter(mon, analysis=pf2, noise=False)
        add_wattmeter(mon, analysis=pf2, noise=False)
        add_varmeter(mon, analysis=pf2, noise=False)
        out["se_rows"] = (mon.voltmeter.number + mon.wattmeter.number
                          + mon.varmeter.number)

        print(json.dumps({"phase": "se_monitored", "rows": out["se_rows"]}),
              flush=True)
        t0 = time.perf_counter()
        se = gauss_newton_bbd(mon, n_blocks=args.blocks)
        out["se_setup_s"] = round(time.perf_counter() - t0, 1)
        print(json.dumps({"phase": "se_routed", **out}), flush=True)
        t0 = time.perf_counter()
        se_bbd_solve(se)
        out["se_first_s"] = round(time.perf_counter() - t0, 1)
        out["se_iterations"] = int(se.method.iteration)
        out["se_converged"] = bool(se.method.converged)
        err = max(
            float(np.max(np.abs(np.asarray(se.voltage.magnitude)
                                - np.asarray(pf2.voltage.magnitude)))),
            float(np.max(np.abs(np.asarray(se.voltage.angle)
                                - np.asarray(pf2.voltage.angle)))))
        out["se_state_err_vs_pf"] = err

        # warm re-solve
        se2 = gauss_newton_bbd(mon, n_blocks=args.blocks)
        t0 = time.perf_counter()
        se_bbd_solve(se2)
        out["se_warm_s"] = round(time.perf_counter() - t0, 2)

    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
