"""External anchoring of the scale path against MATPOWER-published data.

``tests/data/case118.m`` is byte-identical to MATPOWER's distributed
case118 (itself converted from the IEEE 118-bus CDF archive). The bus
matrix's Vm/Va columns carry the published solved operating point, so a
flat(-magnitude) Newton-Raphson run can be checked against numbers NOT
produced by this repo's own oracle (an earlier review found the scale
goldens were self-generated).

Known deviation: MATPOWER changed branches 86-87 and 68-116 from lines
to transformers in 2019 (see the case file header) without re-solving
the stored voltages, so a few magnitudes near those branches differ from
the published state by up to ~0.018 pu; the published angles still match
to < 0.35 degrees everywhere and magnitudes to < 2e-3 at the 95th
percentile. Reference parity: the reference's own scale examples load
this same file (docs/src/examples/cases/matlab/case118.m).
"""

import numpy as np
import pytest

import juliagrid_tpu as jg


@pytest.fixture(scope="module")
def case118_published():
    system = jg.power_system("tests/data/case118.m")
    n = system.bus.number
    vm_pub = system.bus.voltage.magnitude.array[:n].copy()
    va_pub = system.bus.voltage.angle.array[:n].copy()
    return system, vm_pub, va_pub


def test_nr_matches_matpower_published_state(case118_published):
    system, vm_pub, va_pub = case118_published
    n = system.bus.number
    slack = int(np.flatnonzero(system.bus.layout.type.array[:n] == 3)[0])
    system.bus.voltage.magnitude.array[:n] = 1.0
    system.bus.voltage.angle.array[:n] = va_pub[slack]

    pf = jg.newton_raphson(system)
    jg.power_flow(pf)
    assert pf.method.converged
    assert pf.method.iteration == 4  # flat-start NR on case118

    vm = np.asarray(pf.voltage.magnitude)
    va = np.asarray(pf.voltage.angle)
    dva_deg = np.degrees(np.abs(va - va_pub))
    dvm = np.abs(vm - vm_pub)
    assert dva_deg.max() < 0.35
    assert np.percentile(dvm, 95) < 2e-3
    # the 2019 branch edits bound the worst-case magnitude deviation
    assert dvm.max() < 2e-2


def test_self_goldens_consistent_with_published(case118_published):
    """The repo-generated results_large.h5 golden for case118 must agree
    with the MATPOWER-published state within the same envelope — closing
    the 'parity with our own oracle' circularity."""
    import os

    import h5py

    path = "tests/data/results_large.h5"
    if not os.path.exists(path):
        pytest.skip("no results_large.h5 in this checkout")
    _, vm_pub, va_pub = case118_published
    with h5py.File(path, "r") as f:
        if "case118" not in f or "newtonRaphson" not in f["case118"]:
            pytest.skip("no case118 NR golden group")
        grp = f["case118"]["newtonRaphson"]
        vm_g = np.asarray(grp["voltageMagnitude"])
        va_g = np.asarray(grp["voltageAngle"])
    dvm = np.abs(vm_g - vm_pub)
    # the goldens are solved at the file's slack angle, same as published
    dva_deg = np.degrees(np.abs(va_g - va_pub))
    assert np.percentile(dvm, 95) < 2e-3
    assert dvm.max() < 2e-2
    assert dva_deg.max() < 0.35
