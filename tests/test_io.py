"""I/O round-trip tests (pattern of /root/reference/test/powerSystem/
loadSave.jl and measurement/loadSave.jl): parse .m -> save .h5 -> reload ->
field equality; .h5 fixture compatibility; NR equivalence across formats."""

import numpy as np
import pytest

import juliagrid_tpu as jg
from juliagrid_tpu.measurement.load import ems, measurement
from juliagrid_tpu.powerflow.ac import newton_raphson
from juliagrid_tpu.powerflow.driver import power_flow
from juliagrid_tpu.system.hdf5io import save_power_system


def test_h5_fixture_loads_and_solves(data_path):
    system = jg.power_system(str(data_path / "case14.h5"))
    assert system.bus.number == 14
    assert system.branch.number == 20
    assert system.generator.number == 5
    analysis = newton_raphson(system)
    power_flow(analysis)
    assert analysis.method.converged


def test_monitoring_h5_loads(data_path):
    system, monitoring = ems(str(data_path / "case14.h5"),
                             str(data_path / "monitoring.h5"))
    assert monitoring.voltmeter.number == 14
    assert monitoring.wattmeter.number == 54
    assert monitoring.pmu.number == 54
    # and a WLS SE runs on it
    from juliagrid_tpu.estimation.acse import gauss_newton, state_estimation
    se = gauss_newton(monitoring)
    state_estimation(se)
    assert se.method.converged


def test_roundtrip_m_h5(data_path, tmp_path):
    system = jg.power_system(str(data_path / "case14test.m"))
    out = tmp_path / "case14test.h5"
    save_power_system(system, str(out))
    system2 = jg.power_system(str(out))

    n = system.bus.number
    np.testing.assert_allclose(system2.bus.demand.active.array,
                               system.bus.demand.active.array)
    np.testing.assert_allclose(system2.bus.voltage.magnitude.array,
                               system.bus.voltage.magnitude.array)
    np.testing.assert_array_equal(system2.branch.layout.from_bus.array,
                                  system.branch.layout.from_bus.array)
    np.testing.assert_allclose(system2.generator.output.active.array,
                               system.generator.output.active.array)
    assert system2.bus.layout.slack == system.bus.layout.slack
    for gi, poly in system.generator.cost.active.polynomial.items():
        np.testing.assert_allclose(
            system2.generator.cost.active.polynomial[gi], poly)
    for gi, pts in system.generator.cost.active.piecewise.items():
        np.testing.assert_allclose(
            system2.generator.cost.active.piecewise[gi], pts)

    a1 = newton_raphson(system)
    power_flow(a1)
    a2 = newton_raphson(system2)
    power_flow(a2)
    np.testing.assert_allclose(a2.voltage.magnitude, a1.voltage.magnitude,
                               atol=1e-12)
    assert a1.method.iteration == a2.method.iteration


def test_measurement_roundtrip(data_path, tmp_path):
    from juliagrid_tpu.measurement.hdf5io import save_measurement
    system, monitoring = ems(str(data_path / "case14.h5"),
                             str(data_path / "monitoring.h5"))
    out = tmp_path / "monitoring2.h5"
    save_measurement(monitoring, str(out))
    monitoring2 = measurement(system, str(out))
    np.testing.assert_allclose(
        monitoring2.wattmeter.active.mean.array,
        monitoring.wattmeter.active.mean.array)
    np.testing.assert_array_equal(
        monitoring2.pmu.layout.index.array,
        monitoring.pmu.layout.index.array)
    np.testing.assert_allclose(
        monitoring2.pmu.angle.variance.array,
        monitoring.pmu.angle.variance.array)


def test_psse_matches_matpower_fixture(data_path):
    """PSSE .raw vs .m parity (reference loadSave.jl pattern, atol 1e-6)."""
    raw = jg.power_system(str(data_path / "psse.raw"))
    mfile = jg.power_system(str(data_path / "psse.m"))
    assert raw.bus.number == mfile.bus.number
    assert raw.branch.number == mfile.branch.number
    assert raw.generator.number == mfile.generator.number
    np.testing.assert_allclose(raw.bus.demand.active.array,
                               mfile.bus.demand.active.array, atol=1e-6)
    np.testing.assert_allclose(raw.bus.shunt.susceptance.array,
                               mfile.bus.shunt.susceptance.array, atol=1e-6)
    np.testing.assert_allclose(raw.branch.parameter.reactance.array,
                               mfile.branch.parameter.reactance.array,
                               atol=1e-6)
    np.testing.assert_allclose(raw.branch.parameter.turns_ratio.array,
                               mfile.branch.parameter.turns_ratio.array,
                               atol=1e-6)
    np.testing.assert_array_equal(raw.branch.layout.status.array,
                                  mfile.branch.layout.status.array)
    np.testing.assert_array_equal(raw.branch.layout.from_bus.array,
                                  mfile.branch.layout.from_bus.array)
    np.testing.assert_allclose(raw.generator.output.active.array,
                               mfile.generator.output.active.array,
                               atol=1e-6)


def test_psse_three_winding_transformer(tmp_path):
    """3-winding transformers expand to a star bus + three branches
    (reference load.jl:1106-1251)."""
    raw = """0,   100.00, 33, 0, 0, 60.00
TITLE LINE ONE
TITLE LINE TWO
    1, 'Bus 1', 138.0, 3, 1, 1, 1, 1.02, 0.00, 1.1, 0.9, 1.1, 0.9
    2, 'Bus 2', 138.0, 1, 1, 1, 1, 1.00, 0.00, 1.1, 0.9, 1.1, 0.9
    3, 'Bus 3', 69.0, 1, 1, 1, 1, 1.00, 0.00, 1.1, 0.9, 1.1, 0.9
0 / END OF BUS DATA, BEGIN LOAD DATA
    2, '1', 1, 1, 1, 20.00, 8.00, 0.00, 0.00, 0.00, 0.00, 1, 1
    3, '1', 1, 1, 1, 10.00, 4.00, 0.00, 0.00, 0.00, 0.00, 1, 1
0 / END OF LOAD DATA, BEGIN FIXED SHUNT DATA
0 / END OF FIXED SHUNT DATA, BEGIN GENERATOR DATA
    1,'1', 35.00, 10.00, 50.00, -50.00, 1.02, 0, 100.00, 0.00, 1.00, 0.00, 0.00, 1.00, 1, 100.00, 100.00, 0.00, 1, 1.00, 0, 1.00, 0, 1.00, 0, 1.00, 0, 1.00
0 / END OF GENERATOR DATA, BEGIN BRANCH DATA
     1, 2, '1', 0.01, 0.05, 0.02, 100.0, 100.0, 100.0, 0.0, 0.0, 0.0, 0.0, 1, 1, 0.0, 1, 1.00, 0, 1.00, 0, 1.00, 0, 1.00
0 / END OF BRANCH DATA, BEGIN TRANSFORMER DATA
     1, 2, 3, '1', 1, 1, 1, 0.0, 0.0, 2, 'T3W', 1, 1, 1.00, 0, 1.00, 0, 1.00, 0, 1.00, ' '
     0.01, 0.08, 100.0, 0.01, 0.06, 100.0, 0.01, 0.07, 100.0, 1.0, 0.0
     1.0, 0.0, 0.0, 50.0, 50.0, 50.0, 0, 0, 1.1, 0.9, 1.1, 0.9, 33, 0, 0.0, 0.0, 0.0
     1.0, 0.0, 0.0, 50.0, 50.0, 50.0, 0, 0, 1.1, 0.9, 1.1, 0.9, 33, 0, 0.0, 0.0, 0.0
     1.0, 0.0, 0.0, 50.0, 50.0, 50.0, 0, 0, 1.1, 0.9, 1.1, 0.9, 33, 0, 0.0, 0.0, 0.0
0 / END OF TRANSFORMER DATA, BEGIN AREA DATA
Q
"""
    path = tmp_path / "t3w.raw"
    path.write_text(raw)
    system = jg.power_system(str(path))
    # 3 buses + 1 star bus; 1 line + 3 transformer branches
    assert system.bus.number == 4
    assert system.branch.number == 4
    # star arms: (R12 - R23 + R31)/2 etc.
    r = system.branch.parameter.resistance
    x = system.branch.parameter.reactance
    np.testing.assert_allclose(r[1], (0.01 - 0.01 + 0.01) / 2)
    np.testing.assert_allclose(x[1], (0.08 - 0.06 + 0.07) / 2)
    np.testing.assert_allclose(x[2], (0.08 + 0.06 - 0.07) / 2)
    np.testing.assert_allclose(x[3], (-0.08 + 0.06 + 0.07) / 2)
    # all arms end at the star bus
    star = 3
    assert all(int(system.branch.layout.to_bus[k]) == star
               for k in (1, 2, 3))
    # and the expanded system solves
    analysis = newton_raphson(system)
    power_flow(analysis)
    assert analysis.method.converged


def test_h5_multiple_slack_picks_first(data_path, tmp_path):
    """ADVICE r1 / reference load.jl:155-160: with several type-3 buses in
    a file, the FIRST one becomes the slack."""
    import h5py

    system = jg.power_system(str(data_path / "case14test.m"))
    out = tmp_path / "multislack.h5"
    save_power_system(system, str(out))
    with h5py.File(out, "r+") as fh:
        types = fh["bus/layout/type"][...]
        types = np.full(system.bus.number, types, dtype=types.dtype) \
            if types.shape == () else types
        types[2] = 3
        types[7] = 3
        del fh["bus/layout/type"]
        fh["bus/layout/type"] = types
    loaded = jg.power_system(str(out))
    assert loaded.bus.layout.slack == min(
        np.flatnonzero(loaded.bus.layout.type.array[:loaded.bus.number] == 3))


@pytest.mark.parametrize("case", ["case1354pegase", "case_ACTIVSg10k"])
def test_npz_copy_loads_like_h5(case, data_path):
    """The .npz copy (read without h5py) builds the same system."""
    a = jg.power_system(str(data_path / f"{case}.h5"))
    b = jg.power_system(str(data_path / f"{case}.npz"))
    assert (a.bus.number, a.branch.number, a.generator.number) == \
        (b.bus.number, b.branch.number, b.generator.number)
    assert a.bus.label.labels() == b.bus.label.labels()
    assert a.bus.layout.slack == b.bus.layout.slack
    for get in (lambda s: s.bus.layout.type, lambda s: s.bus.demand.active,
                lambda s: s.bus.voltage.magnitude,
                lambda s: s.bus.supply.reactive,
                lambda s: s.branch.parameter.reactance,
                lambda s: s.branch.layout.to_bus,
                lambda s: s.branch.flow.max_from_bus,
                lambda s: s.generator.capability.max_active):
        np.testing.assert_array_equal(get(a).array, get(b).array)
    assert a.generator.cost.active.polynomial.keys() == \
        b.generator.cost.active.polynomial.keys()
    for k, v in a.generator.cost.active.polynomial.items():
        np.testing.assert_array_equal(v, b.generator.cost.active.polynomial[k])


def test_npz_copies_match_h5_files(data_path):
    """The committed .npz files are current copies of their .h5 sources
    (regenerate with benchmarks/h5_to_npz.py)."""
    from benchmarks.h5_to_npz import FILES, h5_arrays

    for name in FILES:
        want = h5_arrays(str(data_path / name))
        with np.load(str(data_path / name.replace(".h5", ".npz"))) as got:
            assert sorted(got.files) == sorted(want)
            for key, value in want.items():
                np.testing.assert_array_equal(got[key], value)
