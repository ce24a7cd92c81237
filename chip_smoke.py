"""Smoke test of the main solver paths on the GPU, checked against references.

    python chip_smoke.py               # one card: the five phases below
    python chip_smoke.py --four-cards  # four cards: the multi-device paths

One card, through the public API (``import juliagrid_tpu as jg``):

  1. Newton-Raphson power flow on case1354pegase vs the golden results
     (tests/data/results_large.h5): exact iteration count, |V| and θ.
  2. Fast-decoupled (BX, XB) and DC power flow on pegase vs the goldens.
  3. WLS state estimation on pegase: a zero-noise SCADA+PMU set reproduces
     the power flow; a Monte-Carlo fleet of noisy sets converges in every
     lane and lane 0 matches the scipy oracle; the largest-normalized-
     residual test flags and removes a planted gross error.
  4. AC OPF on pegase vs MATPOWER's optimum.
  5. ACTIVSg10k Newton-Raphson on the BBD/Schur substrate vs the oracle.

Four cards: scenario-sharded NR and SE fleets vs the same fleets on one
card, the device-sharded BBD Schur solve vs the one-device solve, and the
AC OPF with its KKT blocks factored one per card vs the dense-KKT OPF.

Each phase prints one line: its wall time, each comparison and its
tolerance. A failed comparison or an exception ends the script with a
non-zero exit. The last line of a passing run is one JSON object naming
the device. There is no CPU fallback: the script exits non-zero unless
JAX's first device is a GPU.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "tests", "data")
PEGASE = os.path.join(DATA, "case1354pegase.npz")
GOLDENS = os.path.join(DATA, "results_large.npz")
ACTIVSG10K = os.path.join(DATA, "case_ACTIVSg10k.npz")
# MATPOWER's published optimum for case1354pegase (runopf, $/h)
PEGASE_OPF_OBJECTIVE = 74069.35
SEED = 0


class SmokeFailure(AssertionError):
    pass


class Phase:
    """Collects one phase's comparisons and prints them on one line."""

    def __init__(self, name):
        self.name = name
        self.parts = []
        self.t0 = time.perf_counter()

    def _add(self, text, ok):
        self.parts.append(text)
        if not ok:
            raise SmokeFailure(f"{self.name}: " + " | ".join(self.parts)
                               + "  <- FAILED")

    def within(self, what, err, tol):
        err = float(err)
        self._add(f"{what} {err:.3e} <= {tol:.0e}", err <= tol)

    def equal(self, what, got, want):
        self._add(f"{what} {got} == {want}", got == want)

    def true(self, what, value, shown=None):
        self._add(f"{what} {value if shown is None else shown}", bool(value))

    def note(self, text):
        self.parts.append(text)

    def done(self):
        wall = time.perf_counter() - self.t0
        print(f"{self.name}: {wall:.2f} s | " + " | ".join(self.parts),
              flush=True)


def _maxabs(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _readable(path):
    """Cases and goldens are read from the .npz copies of the HDF5 files
    (benchmarks/h5_to_npz.py), so h5py is not needed."""
    if not os.path.exists(path):
        raise SmokeFailure(f"missing {path}: run benchmarks/h5_to_npz.py")
    return path


def _golden(group):
    with np.load(_readable(GOLDENS)) as z:
        return {k[len(group) + 1:]: z[k] for k in z.files
                if k.startswith(group + "/")}


def _device_header(count):
    """Refuse anything but ``count`` GPUs; print the cards and JAX's view."""
    from juliagrid_tpu.utils.profiling import gpu_report

    try:
        report = gpu_report()
    except RuntimeError as exc:
        sys.exit(f"chip_smoke: {exc}")
    if report["count"] != count:
        sys.exit(f"chip_smoke: needs {count} GPU(s), JAX sees "
                 f"{report['count']}")
    for card in report["cards"]:
        print(card)
    print(f"jax {report['jax']} | device_kind {report['device_kind']} "
          f"| devices {report['count']}", flush=True)
    return report


def _scada_pmu(system, pf, noise, pmu_every=10):
    """SCADA (voltmeters, watt/varmeters everywhere) + polar bus PMUs on
    every ``pmu_every``-th bus, measured off a solved power flow."""
    import juliagrid_tpu as jg

    mon = jg.measurement(system)
    jg.add_voltmeter(mon, analysis=pf, noise=noise)
    jg.add_wattmeter(mon, analysis=pf, noise=noise)
    jg.add_varmeter(mon, analysis=pf, noise=noise)
    for b in range(0, system.bus.number, pmu_every):
        jg.add_pmu(mon, bus=system.bus.label.label(b),
                   magnitude=float(pf.voltage.magnitude[b]),
                   angle=float(pf.voltage.angle[b]), polar=True, noise=noise)
    return mon


def _se_means(arr_host, nscen, spread=0.5):
    """Scenario measurement means: lane 0 is the set itself, the other
    lanes add Gaussian noise of ``spread`` standard deviations."""
    rng = np.random.default_rng(SEED)
    base = np.asarray(arr_host.mean)
    sigma = 1.0 / np.sqrt(np.asarray(arr_host.w))
    means = base[None, :] + spread * sigma[None, :] * rng.standard_normal(
        (nscen, base.shape[0]))
    means[0] = base
    return means


# ---------------------------------------------------------------------------
# One card
# ---------------------------------------------------------------------------

def phase_nr(system, golden):
    import juliagrid_tpu as jg

    ph = Phase("1 nr case1354pegase")
    pf = jg.newton_raphson(system)
    jg.power_flow(pf, power=True)
    ph.true("converged", pf.method.converged)
    ph.equal("iterations", pf.method.iteration, int(golden["iteration"][0]))
    ph.within("max|dVm|", _maxabs(pf.voltage.magnitude,
                                  golden["voltageMagnitude"]), 1e-8)
    ph.within("max|dVa|", _maxabs(pf.voltage.angle,
                                  golden["voltageAngle"]), 1e-8)
    ph.done()
    return pf


def phase_fdpf_dc(path, goldens):
    import juliagrid_tpu as jg

    ph = Phase("2 fdpf+dc case1354pegase")
    for label, make in (("fastNewtonRaphsonBX", jg.fast_newton_raphson_bx),
                        ("fastNewtonRaphsonXB", jg.fast_newton_raphson_xb)):
        golden = goldens[label]
        pf = make(jg.power_system(path))
        jg.power_flow(pf, iteration=1500)
        tag = label[-2:]
        ph.true(f"{tag} converged", pf.method.converged)
        ph.equal(f"{tag} iterations", pf.method.iteration,
                 int(golden["iteration"][0]))
        ph.within(f"{tag} max|dVm|", _maxabs(pf.voltage.magnitude,
                                             golden["voltageMagnitude"]),
                  1e-7)
        ph.within(f"{tag} max|dVa|", _maxabs(pf.voltage.angle,
                                             golden["voltageAngle"]), 1e-7)
    dc = jg.dc_power_flow(jg.power_system(path))
    jg.power_flow(dc)
    ph.within("DC max|dVa|", _maxabs(dc.voltage.angle,
                                     goldens["dcPowerFlow"]["voltage"]),
              1e-8)
    ph.done()


def phase_se(system, pf, nscen=64, bytes_limit=None):
    import jax
    import jax.numpy as jnp

    import juliagrid_tpu as jg
    from juliagrid_tpu.estimation.acse import compile_se_arrays
    from juliagrid_tpu.measurement.devices import seed
    from juliagrid_tpu.oracle import oracle_wls_se
    from juliagrid_tpu.parallel.batch import (batched_se_solve_jit,
                                              se_chunk_size)
    from juliagrid_tpu.powerflow.ac import compile_ac_arrays

    ph = Phase("3 wls se case1354pegase")
    n = system.bus.number

    # single case: the zero-noise set must reproduce the power flow
    mon = _scada_pmu(system, pf, noise=False)
    se = jg.gauss_newton(mon)
    jg.state_estimation(se)
    ph.true("single converged", se.method.converged)
    ph.within("single max|dVm| vs pf",
              _maxabs(se.voltage.magnitude, pf.voltage.magnitude), 1e-8)
    ph.within("single max|dVa| vs pf",
              _maxabs(se.voltage.angle, pf.voltage.angle), 1e-8)

    # bad data: a gross error planted on one wattmeter is flagged and
    # its device taken out of service
    bad_label = mon.wattmeter.label.label(5)
    jg.update_wattmeter(mon, bad_label, active=5.0)
    se_bad = jg.gauss_newton(mon)
    jg.state_estimation(se_bad)
    bad = jg.residual_test(se_bad, threshold=3.0)
    ph.true("lnr detect", bad.detect,
            f"{bad.detect} (max normalized residual "
            f"{bad.max_normalized_residual:.1f})")
    ph.equal("lnr label", bad.label, bad_label)
    ph.equal("lnr removed status", int(mon.wattmeter.active.status[5]), 0)

    # Monte-Carlo fleet around a noisy measurement set; lane 0 is that set
    seed(SEED)
    mon_noisy = _scada_pmu(system, pf, noise=True)
    arr, _, _, arr_h = compile_se_arrays(system, mon_noisy, return_host=True)
    net = compile_ac_arrays(system)
    rows = int(arr_h.mean.shape[0])
    if bytes_limit is None:
        bytes_limit = jax.devices()[0].memory_stats()["bytes_limit"]
    chunk = se_chunk_size(rows, n, bytes_limit, cap=nscen)
    means = _se_means(arr_h, nscen)
    vm0 = jnp.asarray(np.tile(system.bus.voltage.magnitude.array[:n],
                              (chunk, 1)))
    va0 = jnp.asarray(np.tile(system.bus.voltage.angle.array[:n],
                              (chunk, 1)))
    vms, vas, conv = [], [], []
    for k in range(0, nscen, chunk):
        vm, va, _, cv = batched_se_solve_jit(
            arr, net, vm0, va0, jnp.asarray(means[k:k + chunk]),
            tol=1e-8, max_iter=40)
        vms.append(np.asarray(vm))
        vas.append(np.asarray(va))
        conv.append(np.asarray(cv))
    conv = np.concatenate(conv)
    ph.note(f"fleet {nscen} scenarios, chunk {chunk}, rows {rows}")
    ph.equal("fleet converged", int(conv.sum()), nscen)
    ref = oracle_wls_se(system, mon_noisy)
    ph.true("oracle converged", ref.converged)
    # both solvers stop once max|dx| < 1e-8, so each state sits within
    # about one such increment of the same WLS optimum
    ph.within("lane0 max|dVm| vs oracle", _maxabs(vms[0][0], ref.magnitude),
              1e-7)
    ph.within("lane0 max|dVa| vs oracle", _maxabs(vas[0][0], ref.angle),
              1e-7)
    ph.done()


def phase_opf(path):
    import juliagrid_tpu as jg

    ph = Phase("4 ac opf case1354pegase")
    opf = jg.ac_optimal_power_flow(jg.power_system(path))
    jg.solve_opf(opf)
    res = opf.method.result
    ph.true("status", res.status in ("optimal", "acceptable"), res.status)
    rel = abs(res.objective - PEGASE_OPF_OBJECTIVE) / PEGASE_OPF_OBJECTIVE
    ph.within(f"objective {res.objective:.4f} rel err vs MATPOWER", rel,
              1e-6)
    ph.note(f"kkt error {res.kkt_error:.3e}")
    ph.note(f"iterations {res.iterations}")
    ph.note(f"f64 endgame {res.f64_endgame}")
    ph.done()


def phase_nr_bbd(path, n_blocks=16):
    import juliagrid_tpu as jg
    from juliagrid_tpu.oracle import oracle_nr

    ph = Phase("5 nr bbd case_ACTIVSg10k")
    system = jg.power_system(path)
    pf = jg.newton_raphson_bbd(system, n_blocks=n_blocks)
    jg.power_flow_bbd(pf)
    ref = oracle_nr(jg.power_system(path))
    ph.note(f"{system.bus.number} buses, {n_blocks} blocks")
    ph.true("converged", pf.method.converged)
    ph.equal("iterations", pf.method.iteration, ref.iterations)
    ph.within("max|dVm| vs oracle", _maxabs(pf.voltage.magnitude,
                                            ref.magnitude), 1e-8)
    ph.within("max|dVa| vs oracle", _maxabs(pf.voltage.angle, ref.angle),
              1e-8)
    ph.done()


def run_one_card():
    import juliagrid_tpu as jg

    goldens = {g: _golden(f"case1354pegase/{g}")
               for g in ("newtonRaphson", "fastNewtonRaphsonBX",
                         "fastNewtonRaphsonXB", "dcPowerFlow")}
    pegase = _readable(PEGASE)
    system = jg.power_system(pegase)
    pf = phase_nr(system, goldens["newtonRaphson"])
    phase_fdpf_dc(pegase, goldens)
    phase_se(system, pf)
    phase_opf(pegase)
    phase_nr_bbd(_readable(ACTIVSG10K))


# ---------------------------------------------------------------------------
# Four cards
# ---------------------------------------------------------------------------

def phase_sharded_fleets(system, pf, mesh, n_nr=64, n_se=32):
    import jax.numpy as jnp

    from juliagrid_tpu.estimation.acse import compile_se_arrays
    from juliagrid_tpu.measurement.devices import seed
    from juliagrid_tpu.parallel.batch import (batched_nr_solve_jit,
                                              batched_se_solve_jit,
                                              sharded_nr_solve,
                                              sharded_se_solve)
    from juliagrid_tpu.powerflow.ac import compile_ac_arrays

    ph = Phase("sharded fleets case1354pegase")
    n = system.bus.number
    arr = compile_ac_arrays(system)
    rng = np.random.default_rng(SEED)
    scale = 1.0 + 0.05 * rng.standard_normal((n_nr, 1))
    p = jnp.asarray(np.asarray(arr.p_sched)[None, :] * scale)
    q = jnp.asarray(np.asarray(arr.q_sched)[None, :] * scale)
    vm0 = jnp.asarray(np.tile(pf.voltage.magnitude, (n_nr, 1)))
    va0 = jnp.asarray(np.tile(pf.voltage.angle, (n_nr, 1)))
    one = batched_nr_solve_jit(arr, vm0, va0, p, q, tol=1e-8, max_iter=20)
    four = sharded_nr_solve(mesh, arr, vm0, va0, p, q, tol=1e-8,
                            max_iter=20)
    one, four = [tuple(np.asarray(x) for x in r) for r in (one, four)]
    ph.note(f"nr fleet {n_nr} scenarios")
    ph.equal("nr converged 1 card", int(one[3].sum()), n_nr)
    ph.equal("nr converged 4 cards", int(four[3].sum()), n_nr)
    ph.true("nr iterations per lane equal", np.array_equal(one[2], four[2]))
    ph.within("nr max|dVm| 4 vs 1", _maxabs(one[0], four[0]), 1e-10)
    ph.within("nr max|dVa| 4 vs 1", _maxabs(one[1], four[1]), 1e-10)

    seed(SEED)
    mon = _scada_pmu(system, pf, noise=True)
    se_arr, _, _, se_h = compile_se_arrays(system, mon, return_host=True)
    means = jnp.asarray(_se_means(se_h, n_se))
    svm0 = jnp.asarray(np.tile(system.bus.voltage.magnitude.array[:n],
                               (n_se, 1)))
    sva0 = jnp.asarray(np.tile(system.bus.voltage.angle.array[:n],
                               (n_se, 1)))
    one = batched_se_solve_jit(se_arr, arr, svm0, sva0, means, tol=1e-8,
                               max_iter=40)
    four = sharded_se_solve(mesh, se_arr, arr, svm0, sva0, means, tol=1e-8,
                            max_iter=40)
    one, four = [tuple(np.asarray(x) for x in r) for r in (one, four)]
    ph.note(f"se fleet {n_se} scenarios")
    ph.equal("se converged 1 card", int(one[3].sum()), n_se)
    ph.equal("se converged 4 cards", int(four[3].sum()), n_se)
    ph.true("se iterations per lane equal", np.array_equal(one[2], four[2]))
    ph.within("se max|dVm| 4 vs 1", _maxabs(one[0], four[0]), 1e-10)
    ph.within("se max|dVa| 4 vs 1", _maxabs(one[1], four[1]), 1e-10)
    ph.done()


def phase_sharded_bbd(system, mesh):
    import jax.numpy as jnp

    import juliagrid_tpu as jg
    from juliagrid_tpu.ops.bbd import (bbd_partition, bbd_solve,
                                       bbd_solve_sharded, build_bbd_arrays)

    ph = Phase("sharded bbd schur case1354pegase dc")
    jg.dc_model(system)
    n = system.bus.number
    nodal = system.model.dc.nodal.tocsr()
    m = np.ones(n)
    m[system.bus.layout.slack] = 0.0
    a = (np.diag(m) @ nodal.toarray() @ np.diag(m)) + np.diag(1.0 - m)
    rhs = (system.bus.supply.active.array[:n]
           - system.bus.demand.active.array[:n]) * m
    adjacency = nodal.copy()
    adjacency.eliminate_zeros()
    block_of, border = bbd_partition(adjacency, 4)
    bbd = build_bbd_arrays(a, block_of, border)
    x1 = np.asarray(bbd_solve(bbd, jnp.asarray(rhs)))
    x4 = np.asarray(bbd_solve_sharded(mesh, bbd, jnp.asarray(rhs)))
    scale = np.max(np.abs(x1))
    ph.note(f"{n} buses, 4 blocks, border {len(border)}")
    ph.within("residual 4 cards", np.max(np.abs(a @ x4 - rhs))
              / np.max(np.abs(rhs)), 1e-10)
    ph.within("max|dx| 4 vs 1 (relative)", _maxabs(x1, x4) / scale, 1e-10)
    ph.done()


def phase_sharded_opf(path, mesh):
    import juliagrid_tpu as jg
    from juliagrid_tpu.opf.acopf import solve as ac_solve

    ph = Phase("kkt-mesh ac opf")
    dense = jg.ac_optimal_power_flow(jg.power_system(path))
    ac_solve(dense, kkt_blocks=0)
    shard = jg.ac_optimal_power_flow(jg.power_system(path))
    ac_solve(shard, kkt_blocks=4, kkt_mesh=mesh)
    rd, rs = dense.method.result, shard.method.result
    ph.note(os.path.basename(path))
    ph.true("dense status", rd.status in ("optimal", "acceptable"),
            rd.status)
    ph.true("mesh status", rs.status in ("optimal", "acceptable"), rs.status)
    rel = abs(rs.objective - rd.objective) / abs(rd.objective)
    ph.within(f"objective {rs.objective:.4f} rel err vs dense "
              f"{rd.objective:.4f}", rel, 1e-6)
    ph.done()


def run_four_cards(opf_case=os.path.join(DATA, "case118.m")):
    import jax
    from jax.sharding import Mesh

    import juliagrid_tpu as jg
    from juliagrid_tpu.parallel.batch import scenario_mesh

    system = jg.power_system(_readable(PEGASE))
    pf = jg.newton_raphson(system)
    jg.power_flow(pf, power=True)
    phase_sharded_fleets(system, pf, scenario_mesh(4))
    bmesh = Mesh(np.array(jax.devices()[:4]), ("block",))
    phase_sharded_bbd(jg.power_system(PEGASE), bmesh)
    phase_sharded_opf(opf_case, bmesh)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device paths, on four GPUs")
    args = ap.parse_args()
    count = 4 if args.four_cards else 1
    report = _device_header(count)
    if args.four_cards:
        run_four_cards()
    else:
        run_one_card()
    print(json.dumps({"ok": True, "device": {
        "platform": report["platform"], "kind": report["device_kind"],
        "count": report["count"]}}), flush=True)


if __name__ == "__main__":
    main()
