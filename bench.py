"""Benchmark: the BASELINE configurations on one GPU.

Measures the named BASELINE.json configurations:

  1. Newton-Raphson AC power flow, IEEE 14, flat start (single case + fleet)
  2. DC power flow + fast-decoupled AC power flow, IEEE 118
  3. Gauss-Newton WLS SE, SCADA+PMU set, IEEE 118 (batched Monte-Carlo)
  4. LAV SE + largest-normalized-residual bad-data loop, IEEE 118
  5. Interior-point AC OPF on case1354pegase + batched Monte-Carlo WLS SE
     on case1354pegase (reported as solves/s)

``vs_baseline`` is the geometric mean of per-config speedups against the
independent sparse CPU oracle (juliagrid_tpu/oracle/sparse_ref.py): serial
CSC fill + splu factorization — the reference's stack shape (SURVEY §3.1),
validated exactly against the MATPOWER goldens (tests/test_oracle.py).
LAV and AC OPF have no scipy-class oracle (the reference rides Ipopt);
they are reported as absolute numbers without a ratio.

One process runs the configs in order (``BENCH_ONLY=1,3,5b`` selects a
subset) and flushes one JSON line after each; the last line is the
summary. Every line names the device (platform, device kind, count) and
each card's name and power limit. The script refuses to run unless JAX's
first device is a GPU, and exits non-zero if any config raised.
"""

import json
import os
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "tests", "data")
TOL = 1e-8
_REPS = 3


def _case(name):
    import juliagrid_tpu as jg
    return jg.power_system(os.path.join(DATA, name))


def _best(fn, reps=3):
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _flat_start(system):
    n = system.bus.number
    system.bus.voltage.magnitude.array[:n] = 1.0
    system.bus.voltage.angle.array[:n] = 0.0


def _scada_pmu(system, pmu_every=10):
    """SCADA+PMU measurement set from the solved power flow."""
    from juliagrid_tpu.measurement.devices import (add_pmu, add_varmeter,
                                                   add_voltmeter,
                                                   add_wattmeter)
    from juliagrid_tpu.measurement.load import measurement
    from juliagrid_tpu.powerflow.ac import newton_raphson
    from juliagrid_tpu.powerflow.driver import power_flow

    pf = newton_raphson(system)
    power_flow(pf, power=True)
    mon = measurement(system)
    add_voltmeter(mon, analysis=pf, noise=False)
    add_wattmeter(mon, analysis=pf, noise=False)
    add_varmeter(mon, analysis=pf, noise=False)
    for b in range(0, system.bus.number, pmu_every):
        add_pmu(mon, bus=system.bus.label.label(b),
                magnitude=float(pf.voltage.magnitude[b]),
                angle=float(pf.voltage.angle[b]), polar=True, noise=False)
    return mon, pf


# ---------------------------------------------------------------------------
# Config 1: NR IEEE-14 flat start (single case)
# ---------------------------------------------------------------------------

def _dispatch_floor_ms():
    """Round-trip latency of a trivial jitted op — the fixed cost every
    single-case number pays per device call. Reported so sub-ms solve
    latencies are interpretable."""
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda x: x + 1.0)
    x = jnp.zeros(8)
    f(x).block_until_ready()
    best = np.inf
    for _ in range(5):
        t0 = time.perf_counter()
        f(x).block_until_ready()
        best = min(best, time.perf_counter() - t0)
    return round(best * 1e3, 3)


def config1_nr14():
    import jax.numpy as jnp

    from juliagrid_tpu.oracle import oracle_nr
    from juliagrid_tpu.parallel.batch import batched_nr_solve_jit
    from juliagrid_tpu.powerflow.ac import _nr_solve, newton_raphson

    system = _case("case14.m")
    _flat_start(system)
    analysis = newton_raphson(system)
    arr = analysis.arrays
    vm0 = jnp.asarray(analysis.voltage.magnitude)
    va0 = jnp.asarray(analysis.voltage.angle)

    def run():
        vm, va, it, *_ = _nr_solve(arr, vm0, va0, TOL, 20, "LU")
        vm.block_until_ready()
        return it

    iters = int(run())  # warmup/compile
    t_fw = _best(run)

    res = oracle_nr(system)
    # best-of-N on the oracle too: a single serial-CPU measurement under
    # host contention makes the fleet RATIO vary from run to run
    t_cpu = _best(lambda: oracle_nr(system))
    assert res.iterations == iters, (res.iterations, iters)

    # BASELINE metric "NR iterations/s": fleet throughput (vmap over
    # scenarios); the single-case number above is dominated by dispatch
    nscen = 1024
    n = system.bus.number
    vm_b = jnp.asarray(np.tile(np.asarray(vm0), (nscen, 1)))
    va_b = jnp.asarray(np.tile(np.asarray(va0), (nscen, 1)))
    rng = np.random.default_rng(0)
    scale = 1.0 + 0.05 * rng.standard_normal((nscen, 1))
    p_b = jnp.asarray(
        np.asarray(analysis.arrays.p_sched)[None, :] * scale)
    q_b = jnp.asarray(
        np.asarray(analysis.arrays.q_sched)[None, :] * scale)

    def run_fleet():
        vm, va, its, conv = batched_nr_solve_jit(
            arr, vm_b, va_b, p_b, q_b, tol=TOL, max_iter=20)
        vm.block_until_ready()
        return int(np.asarray(its).sum()), int(np.asarray(conv).sum())

    total_it, conv = run_fleet()      # warmup: compile outside the clock
    t_fleet = _best(run_fleet, reps=_REPS)
    rate_iters = total_it / t_fleet
    rate_cpu = iters / t_cpu          # serial oracle iterations/s
    return {
        "fw_ms": round(t_fw * 1e3, 3), "cpu_ms": round(t_cpu * 1e3, 3),
        "iterations": iters,
        "dispatch_floor_ms": _dispatch_floor_ms(),
        "fleet_scenarios": nscen, "fleet_converged": conv,
        "fleet_nr_iterations_per_s": round(rate_iters, 0),
        "cpu_nr_iterations_per_s": round(rate_cpu, 0),
        # fleet-throughput ratio (1024-scenario vmap vs one serial oracle
        # solve) — renamed from round-3's "speedup" so round-over-round
        # numbers aren't read as a single-case latency ratio
        "fleet_speedup": round(rate_iters / rate_cpu, 2),
    }


# ---------------------------------------------------------------------------
# Config 2: DC PF + fast-decoupled AC PF, IEEE 118
# ---------------------------------------------------------------------------

def config2_dc_fdpf_118():
    import jax.numpy as jnp

    from juliagrid_tpu.oracle import oracle_dc, oracle_fdpf
    from juliagrid_tpu.powerflow.dc import _dc_solve, dc_power_flow
    from juliagrid_tpu.powerflow.fast_decoupled import (_fnr_solve,
                                                        fast_newton_raphson_bx)

    system = _case("case118.m")

    pf = dc_power_flow(system)

    def run_dc():
        th = _dc_solve(pf.arrays, "LU")
        th.block_until_ready()
        return th

    th = run_dc()
    t_dc = _best(run_dc)
    t0 = time.perf_counter()
    res_dc = oracle_dc(system)
    t_dc_cpu = time.perf_counter() - t0
    assert np.max(np.abs(np.asarray(th) - res_dc.angle)) < 1e-6

    # fleet throughput (vmap over demand scenarios) through the PRODUCT
    # batched-DC API — the benched path is the shipped path
    from juliagrid_tpu.parallel import batched_dc_solve_jit
    nscen_dc = 1024
    rng = np.random.default_rng(1)
    p_b = jnp.asarray(np.asarray(pf.arrays.p_sched)[None, :]
                      * (1.0 + 0.05 * rng.standard_normal((nscen_dc, 1))))

    def run_dc_fleet(p_b):
        return batched_dc_solve_jit(pf.arrays, p_b)

    run_dc_fleet(p_b).block_until_ready()
    t0 = time.perf_counter()
    run_dc_fleet(p_b).block_until_ready()
    t_dc_fleet = time.perf_counter() - t0
    dc_rate = nscen_dc / t_dc_fleet
    dc_rate_cpu = 1.0 / t_dc_cpu

    fd = fast_newton_raphson_bx(system)
    arr = fd.arrays
    vm0 = jnp.asarray(fd.voltage.magnitude)
    va0 = jnp.asarray(fd.voltage.angle)

    def run_fd():
        vm, va, it, *_ = _fnr_solve(arr, vm0, va0, TOL, 200, "LU")
        vm.block_until_ready()
        return it

    iters = int(run_fd())
    t_fd = _best(run_fd)
    t0 = time.perf_counter()
    res_fd = oracle_fdpf(system, bx=True, iteration=200)
    t_fd_cpu = time.perf_counter() - t0
    assert res_fd.iterations == iters, (res_fd.iterations, iters)
    return {
        "dc_fw_ms": round(t_dc * 1e3, 3),
        "dc_cpu_ms": round(t_dc_cpu * 1e3, 3),
        "dc_fleet_scenarios": nscen_dc,
        "dc_fleet_solves_per_s": round(dc_rate, 1),
        "dc_cpu_solves_per_s": round(dc_rate_cpu, 1),
        "dc_speedup": round(dc_rate / dc_rate_cpu, 2),
        "dispatch_floor_ms": _dispatch_floor_ms(),
        "fdpf_fw_ms": round(t_fd * 1e3, 3),
        "fdpf_cpu_ms": round(t_fd_cpu * 1e3, 3),
        "fdpf_iterations": iters,
        "fdpf_single_case_speedup": round(t_fd_cpu / t_fd, 2),
    }


# ---------------------------------------------------------------------------
# Config 3: batched Monte-Carlo GN WLS SE, SCADA+PMU, IEEE 118
# ---------------------------------------------------------------------------

def _se_scenarios(arr_host, nscen, spread=0.5, rng_seed=3):
    """Scenario means around the host mirror ``arr_host`` of the SE
    arrays: ``spread`` standard deviations of Gaussian noise."""
    rng = np.random.default_rng(rng_seed)
    base = np.asarray(arr_host.mean)
    sigma = 1.0 / np.sqrt(np.asarray(arr_host.w))
    return base[None, :] + spread * sigma[None, :] * rng.standard_normal(
        (nscen, len(base)))


def _chunk(rows, n_bus, cap):
    """Scenario chunk of the batched SE that fits this GPU's memory."""
    import jax

    from juliagrid_tpu.parallel.batch import se_chunk_size
    return se_chunk_size(rows, n_bus,
                         jax.devices()[0].memory_stats()["bytes_limit"], cap)


def config3_se118():
    import jax.numpy as jnp

    from juliagrid_tpu.estimation.acse import compile_se_arrays
    from juliagrid_tpu.oracle import oracle_wls_se
    from juliagrid_tpu.parallel.batch import batched_se_solve_jit
    from juliagrid_tpu.powerflow.ac import compile_ac_arrays

    system = _case("case118.m")
    mon, pf = _scada_pmu(system)
    arr, _, _, arr_h = compile_se_arrays(system, mon, return_host=True)
    net = compile_ac_arrays(system)
    n = system.bus.number
    rows = int(arr_h.mean.shape[0])

    nscen = 1024
    chunk = _chunk(rows, n, cap=1024)
    means = _se_scenarios(arr_h, nscen)
    vm0 = jnp.asarray(np.tile(system.bus.voltage.magnitude.array[:n],
                              (chunk, 1)))
    va0 = jnp.asarray(np.tile(system.bus.voltage.angle.array[:n],
                              (chunk, 1)))

    def run_chunk(mz):
        vm, va, iters, conv = batched_se_solve_jit(
            arr, net, vm0, va0, jnp.asarray(mz), tol=TOL, max_iter=40)
        vm.block_until_ready()
        return iters, conv

    run_chunk(means[:chunk])  # warmup/compile

    def run_all():
        tot_it, tot_conv = 0, 0
        for k in range(0, nscen, chunk):
            iters, conv = run_chunk(means[k:k + chunk])
            tot_it += int(np.asarray(iters).sum())
            tot_conv += int(np.asarray(conv).sum())
        return tot_it, tot_conv

    t0 = time.perf_counter()
    total_iters, total_conv = run_all()
    t_fw = time.perf_counter() - t0

    # serial sparse oracle rate (subsample; scale by scenario count)
    n_cpu = min(8, nscen)
    t0 = time.perf_counter()
    for _ in range(n_cpu):
        res = oracle_wls_se(system, mon)
    t_cpu_each = (time.perf_counter() - t0) / n_cpu
    assert res.converged
    rate_fw = nscen / t_fw
    rate_cpu = 1.0 / t_cpu_each
    return {
        "scenarios": nscen, "chunk": chunk,
        "converged": total_conv,
        "gn_iterations": total_iters,
        "fw_solves_per_s": round(rate_fw, 1),
        "cpu_solves_per_s": round(rate_cpu, 1),
        "fw_wall_s": round(t_fw, 4),
        "speedup": round(rate_fw / rate_cpu, 2),
        "rows": rows,
    }


# ---------------------------------------------------------------------------
# Config 4: LAV SE + largest-normalized-residual loop, IEEE 118
# ---------------------------------------------------------------------------

def config4_lav_baddata_118():
    import scipy.sparse as sp
    from scipy.sparse.linalg import splu

    from juliagrid_tpu.estimation.acse import gauss_newton, state_estimation
    from juliagrid_tpu.estimation.baddata import _deactivate, lnr_removal
    from juliagrid_tpu.estimation.lav import ac_lav_state_estimation
    from juliagrid_tpu.measurement.devices import update_wattmeter
    from juliagrid_tpu.oracle import oracle_wls_se

    system = _case("case118.m")
    mon, pf = _scada_pmu(system)
    # two gross errors for the LNR loop to find
    update_wattmeter(mon, mon.wattmeter.label.label(3), active=5.0)
    update_wattmeter(mon, mon.wattmeter.label.label(40), active=-4.0)

    def make_mon():
        m, _ = _scada_pmu(system)
        update_wattmeter(m, m.wattmeter.label.label(3), active=5.0)
        update_wattmeter(m, m.wattmeter.label.label(40), active=-4.0)
        return m

    def lnr_loop(m):
        # device-fused detect-remove-resolve loop: ONE jitted program
        # instead of ~6 dispatches + a dense readback per removal round
        se = gauss_newton(m)
        removed = lnr_removal(se, threshold=3.0, max_remove=10)
        return len(removed), se

    # warm measurement: the first pass pays the compiles; the deployment
    # shape (cyclic re-estimation) runs against the compile cache
    lnr_loop(mon)
    t0 = time.perf_counter()
    removed, se = lnr_loop(make_mon())
    t_fw = time.perf_counter() - t0

    # CPU baseline: oracle WLS + sparse-gain LNR loop (same algorithm:
    # re-estimate, normalized residuals from the residual-covariance
    # diagonal, deactivate the worst row, repeat)
    mon2, _ = _scada_pmu(system)
    update_wattmeter(mon2, mon2.wattmeter.label.label(3), active=5.0)
    update_wattmeter(mon2, mon2.wattmeter.label.label(40), active=-4.0)

    def cpu_loop():
        removed = 0
        while removed < 10:
            res = oracle_wls_se(system, mon2)
            H = res.jacobian.tocsc()
            keep = np.ones(H.shape[1])
            keep[res.slack] = 0.0
            Hm = (H @ sp.diags(keep)).tocsc()
            gain = (Hm.T @ sp.diags(res.weights) @ Hm
                    + sp.diags(1.0 - keep)).tocsc()
            lu = splu(gain)
            ginv_ht = lu.solve(Hm.T.toarray())
            c = 1.0 / res.weights - np.einsum(
                "ji,ji->i", ginv_ht, Hm.toarray().T)
            rn = np.abs(res.residual) / np.sqrt(np.maximum(c, 1e-14))
            k = int(np.argmax(rn))
            if rn[k] <= 3.0:
                break
            kind, dev = res.row_device[k]
            _deactivate(mon2, kind, dev)
            removed += 1
        return removed

    t0 = time.perf_counter()
    removed_cpu = cpu_loop()
    t_cpu = time.perf_counter() - t0

    mon3, _ = _scada_pmu(system)
    state_estimation(ac_lav_state_estimation(mon3))  # compile pass
    lav = ac_lav_state_estimation(mon3)
    t0 = time.perf_counter()
    state_estimation(lav)
    t_lav = time.perf_counter() - t0
    err = float(np.max(np.abs(lav.voltage.magnitude - pf.voltage.magnitude)))
    return {
        "lnr_removed": removed, "lnr_fw_s": round(t_fw, 3),
        "lnr_cpu_removed": removed_cpu, "lnr_cpu_s": round(t_cpu, 3),
        "lnr_speedup": round(t_cpu / t_fw, 2),
        "lav_converged": bool(lav.method.converged),
        "lav_iterations": int(lav.method.iteration),
        "lav_wall_s": round(t_lav, 2),
        "lav_state_err_vs_pf": round(err, 9),
    }


# ---------------------------------------------------------------------------
# Config 5: IPM AC OPF (pegase) + batched Monte-Carlo SE (pegase)
# ---------------------------------------------------------------------------

def config5_opf():
    """AC OPF (interior point) on case1354pegase."""
    from juliagrid_tpu.opf.acopf import ac_optimal_power_flow, solve

    system = _case("case1354pegase.npz")
    opf = ac_optimal_power_flow(system)
    t0 = time.perf_counter()
    solve(opf, max_seconds=1100.0)
    t_opf = time.perf_counter() - t0
    res = opf.method.result
    return {"opf_case": "case1354pegase",
            "opf_converged": bool(opf.method.converged),
            "opf_status": res.status,
            "opf_iterations": int(opf.method.iteration),
            "opf_objective": float(opf.method.objective),
            "opf_kkt_error": float(res.kkt_error),
            "opf_f64_endgame": bool(res.f64_endgame),
            "opf_wall_s": t_opf}


def config5_se():
    """Batched Monte-Carlo WLS SE on case1354pegase."""
    import jax.numpy as jnp

    from juliagrid_tpu.estimation.acse import compile_se_arrays
    from juliagrid_tpu.oracle import oracle_wls_se
    from juliagrid_tpu.parallel.batch import batched_se_solve_jit
    from juliagrid_tpu.powerflow.ac import compile_ac_arrays

    system = _case("case1354pegase.npz")
    mon, pf = _scada_pmu(system, pmu_every=10)
    arr, _, _, arr_h = compile_se_arrays(system, mon, return_host=True)
    net = compile_ac_arrays(system)
    n = system.bus.number
    rows = int(arr_h.mean.shape[0])

    nscen = 256
    chunk = _chunk(rows, n, cap=nscen)
    means = _se_scenarios(arr_h, nscen)
    vm0 = jnp.asarray(np.tile(system.bus.voltage.magnitude.array[:n],
                              (chunk, 1)))
    va0 = jnp.asarray(np.tile(system.bus.voltage.angle.array[:n],
                              (chunk, 1)))

    def run_chunk(mz):
        vm, va, iters, conv = batched_se_solve_jit(
            arr, net, vm0, va0, jnp.asarray(mz), tol=TOL, max_iter=40)
        vm.block_until_ready()
        return iters, conv

    run_chunk(means[:chunk])  # warmup
    t0 = time.perf_counter()
    total_conv = 0
    total_iters = 0
    for k in range(0, nscen, chunk):
        iters, conv = run_chunk(means[k:k + chunk])
        total_conv += int(np.asarray(conv).sum())
        total_iters += int(np.asarray(iters).sum())
    t_fw = time.perf_counter() - t0

    t0 = time.perf_counter()
    res = oracle_wls_se(system, mon)
    t_cpu_each = time.perf_counter() - t0
    assert res.converged
    rate_fw = nscen / t_fw
    rate_cpu = 1.0 / t_cpu_each
    return {
        "se_scenarios": nscen, "se_chunk": chunk,
        "se_converged": total_conv, "se_gn_iterations": total_iters,
        "se_fw_solves_per_s": rate_fw,
        "se_cpu_solves_per_s": rate_cpu,
        "se_speedup": rate_fw / rate_cpu,
        "se_rows": rows,
    }


CONFIGS = {
    "config1_nr14_flat": config1_nr14,
    "config2_dc_fdpf_118": config2_dc_fdpf_118,
    "config3_wls_se_118": config3_se118,
    "config4_lav_baddata_118": config4_lav_baddata_118,
    "config5a_opf_pegase": config5_opf,
    "config5b_se_pegase": config5_se,
}

RATIO_KEYS = {
    "config1_nr14_flat": "fleet_speedup",
    "config2_dc_fdpf_118": "dc_speedup",
    "config3_wls_se_118": "speedup",
    "config4_lav_baddata_118": "lnr_speedup",
    "config5b_se_pegase": "se_speedup",
}


def _select():
    """Config names in order; ``BENCH_ONLY`` ("1,3,5b" short codes or
    full names) picks a subset."""
    only = os.environ.get("BENCH_ONLY")
    if not only:
        return list(CONFIGS)
    sel = only.split(",")
    return [n for n in CONFIGS
            if n in sel or n.split("_")[0].removeprefix("config") in sel]


def main():
    from juliagrid_tpu.utils.profiling import gpu_report

    try:
        device = gpu_report()
    except RuntimeError as exc:
        sys.exit(f"bench: {exc}")
    names = _select()
    if not names:
        sys.exit(f"bench: no configs selected (BENCH_ONLY="
                 f"{os.environ.get('BENCH_ONLY')!r})")
    detail, failed = {}, []
    for name in names:
        t0 = time.perf_counter()
        try:
            res = CONFIGS[name]()
        except Exception:  # report it, run the rest, exit non-zero
            failed.append(name)
            res = {"error": traceback.format_exc(limit=8)}
        res["config_wall_s"] = time.perf_counter() - t0
        detail[name] = res
        print(json.dumps({"config": name, "device": device, **res}),
              flush=True)
    ratios = [detail[n][k] for n, k in RATIO_KEYS.items()
              if k in detail.get(n, {})]
    geomean = float(np.exp(np.mean(np.log(np.maximum(ratios, 1e-12))))) \
        if ratios else 0.0
    print(json.dumps({
        "metric": "baseline_configs_speedup_geomean",
        "value": geomean,
        "unit": "x vs sparse CPU oracle (CSC+splu, reference stack shape)",
        "vs_baseline": geomean,
        "device": device,
        "failed": failed,
    }), flush=True)
    if failed:
        sys.exit(f"bench: configs raised: {', '.join(failed)}")


if __name__ == "__main__":
    main()
