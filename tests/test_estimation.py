"""State-estimation tests following the reference strategy: build
measurements from an exact power-flow solution with zero noise and assert
the estimator reproduces the power-flow voltages
(/root/reference/test/stateEstimation/analysis.jl:19-80 pattern)."""

import numpy as np
import pytest

import juliagrid_tpu as jg
from juliagrid_tpu.estimation.acse import gauss_newton, state_estimation
from juliagrid_tpu.estimation.dcse import dc_state_estimation
from juliagrid_tpu.estimation.pmuse import pmu_state_estimation
from juliagrid_tpu.measurement.devices import (add_pmu, add_varmeter,
                                               add_voltmeter, add_wattmeter,
                                               add_ammeter)
from juliagrid_tpu.measurement.load import measurement
from juliagrid_tpu.postprocessing.ac import current as ac_current
from juliagrid_tpu.postprocessing.ac import power as ac_power
from juliagrid_tpu.postprocessing.dc import power as dc_power
from juliagrid_tpu.powerflow.ac import newton_raphson
from juliagrid_tpu.powerflow.dc import dc_power_flow
from juliagrid_tpu.powerflow.driver import power_flow


@pytest.fixture(scope="module")
def solved14(data_path):
    system = jg.power_system(str(data_path / "case14test.m"))
    pf = newton_raphson(system)
    power_flow(pf)
    ac_power(pf)
    ac_current(pf)
    return system, pf


def test_ac_se_wls_reproduces_pf(solved14):
    system, pf = solved14
    monitoring = measurement(system)
    add_voltmeter(monitoring, analysis=pf)
    add_wattmeter(monitoring, analysis=pf)
    add_varmeter(monitoring, analysis=pf)

    se = gauss_newton(monitoring)
    state_estimation(se)
    assert se.method.converged
    np.testing.assert_allclose(se.voltage.magnitude, pf.voltage.magnitude,
                               atol=1e-8)
    np.testing.assert_allclose(se.voltage.angle, pf.voltage.angle, atol=1e-8)


def test_ac_se_wls_with_ammeters_pmus(solved14):
    system, pf = solved14
    monitoring = measurement(system)
    add_voltmeter(monitoring, analysis=pf)
    add_wattmeter(monitoring, analysis=pf)
    add_varmeter(monitoring, analysis=pf)
    add_ammeter(monitoring, analysis=pf)
    add_pmu(monitoring, analysis=pf)

    se = gauss_newton(monitoring)
    state_estimation(se)
    assert se.method.converged
    np.testing.assert_allclose(se.voltage.magnitude, pf.voltage.magnitude,
                               atol=1e-8)
    np.testing.assert_allclose(se.voltage.angle, pf.voltage.angle, atol=1e-8)


def test_ac_se_wls_polar_correlated_pmus(solved14):
    system, pf = solved14
    monitoring = measurement(system)
    add_voltmeter(monitoring, analysis=pf)
    add_wattmeter(monitoring, analysis=pf)
    add_varmeter(monitoring, analysis=pf)
    add_pmu(monitoring, analysis=pf, polar=True,
            status_from=-1, status_to=-1)
    se = gauss_newton(monitoring)
    state_estimation(se)
    assert se.method.converged
    np.testing.assert_allclose(se.voltage.magnitude, pf.voltage.magnitude,
                               atol=1e-8)

    monitoring2 = measurement(system)
    add_voltmeter(monitoring2, analysis=pf)
    add_wattmeter(monitoring2, analysis=pf)
    add_varmeter(monitoring2, analysis=pf)
    add_pmu(monitoring2, analysis=pf, correlated=True)
    se2 = gauss_newton(monitoring2)
    state_estimation(se2)
    assert se2.method.converged
    np.testing.assert_allclose(se2.voltage.magnitude, pf.voltage.magnitude,
                               atol=1e-8)


def test_ac_se_orthogonal(solved14):
    from juliagrid_tpu.ops import linalg
    system, pf = solved14
    monitoring = measurement(system)
    add_voltmeter(monitoring, analysis=pf)
    add_wattmeter(monitoring, analysis=pf)
    add_varmeter(monitoring, analysis=pf)
    se = gauss_newton(monitoring, factorization=linalg.QR)
    state_estimation(se)
    assert se.method.converged
    np.testing.assert_allclose(se.voltage.magnitude, pf.voltage.magnitude,
                               atol=1e-8)


def test_pmu_se_reproduces_pf(solved14):
    system, pf = solved14
    monitoring = measurement(system)
    add_pmu(monitoring, analysis=pf)
    se = pmu_state_estimation(monitoring)
    state_estimation(se)
    np.testing.assert_allclose(se.voltage.magnitude, pf.voltage.magnitude,
                               atol=1e-8)
    np.testing.assert_allclose(se.voltage.angle, pf.voltage.angle, atol=1e-8)


def test_dc_se_reproduces_dc_pf(data_path):
    system = jg.power_system(str(data_path / "case14test.m"))
    pf = dc_power_flow(system)
    power_flow(pf)
    dc_power(pf)

    monitoring = measurement(system)
    add_wattmeter(monitoring, analysis=pf)
    se = dc_state_estimation(monitoring)
    state_estimation(se)
    np.testing.assert_allclose(se.voltage.angle, pf.voltage.angle, atol=1e-8)


def test_damped_gn_converges_on_hard_polar_set(solved14):
    """Full polar PMU coverage diverges with plain GN from flat start and
    its WLS objective is multimodal (even the reference avoids this
    configuration). The robust workflow: warm-start from the linear
    rectangular PMU estimator, then damped Gauss-Newton."""
    system, pf = solved14
    monitoring = measurement(system)
    add_voltmeter(monitoring, analysis=pf)
    add_wattmeter(monitoring, analysis=pf)
    add_varmeter(monitoring, analysis=pf)
    add_pmu(monitoring, analysis=pf, polar=True)

    lin = pmu_state_estimation(monitoring)
    state_estimation(lin)

    se = gauss_newton(monitoring)
    se.voltage.magnitude = lin.voltage.magnitude.copy()
    se.voltage.angle = lin.voltage.angle.copy()
    state_estimation(se, damping=True, iteration=200)
    assert se.method.converged
    np.testing.assert_allclose(se.voltage.magnitude, pf.voltage.magnitude,
                               atol=1e-7)
    np.testing.assert_allclose(se.voltage.angle, pf.voltage.angle,
                               atol=1e-7)


def test_orthogonal_rejects_correlated_pmus(solved14):
    """ADVICE r1 / reference acStateEstimation.jl:47-49: rectangular
    correlated PMUs carry 2x2 off-diagonal precision blocks the QR path
    cannot represent — constructing it must raise."""
    from juliagrid_tpu.ops import linalg
    system, pf = solved14
    monitoring = measurement(system)
    add_voltmeter(monitoring, analysis=pf)
    add_pmu(monitoring, analysis=pf, correlated=True)
    with pytest.raises(ValueError, match="non-diagonal precision"):
        gauss_newton(monitoring, factorization=linalg.QR)


def test_peters_wilkinson_path(data_path):
    """PW (tall LU + L-normal equations) matches Normal/QR on standard and
    extreme-weight sets (reference acStateEstimation.jl:933-971)."""
    from juliagrid_tpu.measurement.devices import update_voltmeter

    system = jg.power_system(str(data_path / "case14test.m"))
    pf = newton_raphson(system)
    power_flow(pf, power=True)
    mon = measurement(system)
    add_voltmeter(mon, analysis=pf, noise=False)
    add_wattmeter(mon, analysis=pf, noise=False)
    add_varmeter(mon, analysis=pf, noise=False)

    base = gauss_newton(mon, factorization="LU")
    state_estimation(base)
    pw = gauss_newton(mon, factorization="PW")
    state_estimation(pw)
    assert pw.method.converged
    assert pw.method.iteration == base.method.iteration
    np.testing.assert_allclose(pw.voltage.magnitude, base.voltage.magnitude,
                               atol=1e-10)

    # extreme weight ratio (1e17): the square-root methods' home turf
    update_voltmeter(mon, mon.voltmeter.label.label(0), variance=1e-18)
    for v in range(1, mon.voltmeter.number):
        update_voltmeter(mon, mon.voltmeter.label.label(v), variance=1e-1)
    pw = gauss_newton(mon, factorization="PW")
    state_estimation(pw)
    assert pw.method.converged
    np.testing.assert_allclose(pw.voltage.magnitude, pf.voltage.magnitude,
                               atol=1e-9)


def test_normal_path_refinement_gate_ill_conditioned_at_scale(data_path):
    """Residual-gated refinement on the f32 Normal-equations gain,
    ill-conditioned case at 118-bus scale: a 1e16 weight ratio spread
    across the full voltmeter set drives cond(H'WH) ≈ 1e14 — far past the
    nominal cond·eps32 < 1 comfort zone — and the gated sweeps must keep
    refining until the operator residual is tiny (reported via
    ``method.refine_residual``) instead of stopping at a fixed count,
    recovering the exact state."""
    from juliagrid_tpu.estimation.acse import gauss_newton, state_estimation
    from juliagrid_tpu.measurement.devices import (add_varmeter,
                                                   add_voltmeter,
                                                   add_wattmeter)
    from juliagrid_tpu.measurement.load import measurement
    from juliagrid_tpu.powerflow.ac import newton_raphson
    from juliagrid_tpu.powerflow.driver import power_flow

    system = jg.power_system(str(data_path / "case118.m"))
    pf = newton_raphson(system)
    power_flow(pf, power=True)
    assert pf.method.converged
    mon = measurement(system)
    add_voltmeter(mon, analysis=pf, variance=1e-14, noise=False)
    add_wattmeter(mon, analysis=pf, variance=1e2, noise=False)
    add_varmeter(mon, analysis=pf, variance=1e2, noise=False)

    se = gauss_newton(mon, factorization="LU")
    state_estimation(se)
    assert se.method.converged
    assert se.method.refine_residual < 1e-6  # gate satisfied, not tripped
    np.testing.assert_allclose(se.voltage.magnitude, pf.voltage.magnitude,
                               atol=1e-9)
    np.testing.assert_allclose(se.voltage.angle, pf.voltage.angle,
                               atol=1e-7)


def test_normal_path_refinement_gate_escalates_to_qr(data_path):
    """Escalation mechanism: a gain the f32 factorization genuinely cannot
    refine (near-zero-impedance branches, cond ≈ 1e16) must trip the gate
    and re-route the solve through the QR square-root path — the
    reference's own remedy for ill-conditioned normal equations
    (acStateEstimation.jl:878-931) — rather than silently returning
    degraded increments. The doctored network is numerically degenerate
    on purpose; the contract under test is the ESCALATION, not
    convergence of the degenerate estimate."""
    from juliagrid_tpu.estimation.acse import gauss_newton, state_estimation
    from juliagrid_tpu.measurement.devices import (add_varmeter,
                                                   add_voltmeter,
                                                   add_wattmeter)
    from juliagrid_tpu.measurement.load import measurement
    from juliagrid_tpu.powerflow.ac import newton_raphson
    from juliagrid_tpu.powerflow.driver import power_flow

    system = jg.power_system(str(data_path / "case118.m"))
    for k in (5, 50, 100):
        jg.update_branch(system, system.branch.label.label(k),
                         resistance=0.0, reactance=2e-6)
    pf = newton_raphson(system)
    power_flow(pf, power=True)
    mon = measurement(system)
    add_voltmeter(mon, analysis=pf, noise=False)
    add_wattmeter(mon, analysis=pf, noise=False)
    add_varmeter(mon, analysis=pf, noise=False)

    se = gauss_newton(mon, factorization="LU")
    state_estimation(se)
    assert getattr(se.method, "refine_escalated", False), \
        "gate should have escalated the unrefinable Normal path to QR"


def test_se_chunk_size_fits_a_quarter_of_device_memory():
    """Batched-SE chunks are the largest power of two whose estimated
    footprint fits a quarter of the device's memory limit."""
    from juliagrid_tpu.parallel.batch import se_chunk_size

    rows, n = 12298, 1354          # the pegase SCADA+PMU set
    per_scenario = 4 * (2 * rows * 2 * n + 3 * (2 * n) ** 2)
    limit = 63763120128            # 75% of an 80 GB card
    chunk = se_chunk_size(rows, n, limit, cap=256)
    assert chunk == 32
    assert chunk * per_scenario <= limit // 4 < 2 * chunk * per_scenario
    assert se_chunk_size(rows, n, limit, cap=16) == 16
    assert se_chunk_size(rows, n, per_scenario, cap=256) == 1
