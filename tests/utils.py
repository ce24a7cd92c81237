"""Shared test helpers mirroring the reference harness
(/root/reference/test/utility/utility.jl:34-60): golden-oracle voltage and
power comparison plus conservation-law checks."""

import numpy as np


def h5group(path, group):
    import h5py

    out = {}
    with h5py.File(path, "r") as fh:
        grp = fh[group]
        for key, ds in grp.items():
            out[key] = np.asarray(ds)
    return out


def assert_voltage(matpower, analysis, atol=1e-9):
    if "iteration" in matpower:
        assert analysis.method.iteration == int(matpower["iteration"][0]), (
            f"iteration {analysis.method.iteration} != "
            f"{int(matpower['iteration'][0])}")
    np.testing.assert_allclose(
        analysis.voltage.magnitude, matpower["voltageMagnitude"], atol=atol)
    np.testing.assert_allclose(
        analysis.voltage.angle, matpower["voltageAngle"], atol=atol)


def assert_dc_voltage(matpower, analysis, atol=1e-9):
    np.testing.assert_allclose(
        analysis.voltage.angle, matpower["voltage"], atol=atol)


def assert_power(matpower, analysis, atol=1e-9):
    p = analysis.power
    import numpy as np
    np.testing.assert_allclose(p.injection.active, matpower["injectionActive"], atol=atol)
    np.testing.assert_allclose(p.injection.reactive, matpower["injectionReactive"], atol=atol)
    np.testing.assert_allclose(p.supply.active, matpower["supplyActive"], atol=atol)
    np.testing.assert_allclose(p.supply.reactive, matpower["supplyReactive"], atol=atol)
    np.testing.assert_allclose(p.shunt.active, matpower["shuntActive"], atol=atol)
    np.testing.assert_allclose(p.shunt.reactive, matpower["shuntReactive"], atol=atol)
    np.testing.assert_allclose(p.from_.active, matpower["fromActive"], atol=atol)
    np.testing.assert_allclose(p.from_.reactive, matpower["fromReactive"], atol=atol)
    np.testing.assert_allclose(p.to.active, matpower["toActive"], atol=atol)
    np.testing.assert_allclose(p.to.reactive, matpower["toReactive"], atol=atol)
    np.testing.assert_allclose(
        p.charging.reactive, matpower["chargingFrom"] + matpower["chargingTo"], atol=atol)
    np.testing.assert_allclose(p.series.active, matpower["lossActive"], atol=atol)
    np.testing.assert_allclose(p.series.reactive, matpower["lossReactive"], atol=atol)
    np.testing.assert_allclose(p.generator.active, matpower["generatorActive"], atol=atol)
    np.testing.assert_allclose(p.generator.reactive, matpower["generatorReactive"], atol=atol)


def assert_dc_power(matpower, analysis, atol=1e-9):
    import numpy as np
    p = analysis.power
    np.testing.assert_allclose(p.injection.active, matpower["injection"], atol=atol)
    np.testing.assert_allclose(p.supply.active, matpower["supply"], atol=atol)
    np.testing.assert_allclose(p.from_.active, matpower["from"], atol=atol)
    np.testing.assert_allclose(p.to.active, -matpower["from"], atol=atol)
    np.testing.assert_allclose(p.generator.active, matpower["generator"], atol=atol)


def assert_bus_balance(analysis):
    """Conservation: injection = sum of branch powers + shunt at each bus."""
    import numpy as np
    s = analysis.system
    n = s.bus.number
    m = s.branch.number
    f = s.branch.layout.from_bus.array[:m]
    t = s.branch.layout.to_bus.array[:m]
    p = analysis.power
    bal_a = -p.shunt.active.copy()
    bal_r = -p.shunt.reactive.copy()
    bal_a += p.injection.active
    bal_r += p.injection.reactive
    np.subtract.at(bal_a, f, p.from_.active)
    np.subtract.at(bal_r, f, p.from_.reactive)
    np.subtract.at(bal_a, t, p.to.active)
    np.subtract.at(bal_r, t, p.to.reactive)
    np.testing.assert_allclose(bal_a, 0, atol=1e-8)
    np.testing.assert_allclose(bal_r, 0, atol=1e-8)
