"""f32 matrix products on the solver paths run at ``Precision.HIGHEST``.

At default precision a GPU may run an f32 product in TF32 (about three
decimal digits); a factorization or refinement loop fed by such a product
stalls (the batched pegase SE then converges in no lane). The jaxpr of
every solver entry point that forms f32 products is walked here, and every
``dot_general`` with an f32 operand must carry HIGHEST. The last test runs
only on a GPU and checks the QR path's accuracy there."""

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest

import juliagrid_tpu as jg
from juliagrid_tpu.estimation.acse import compile_se_arrays, gn_increment
from juliagrid_tpu.ops import linalg
from juliagrid_tpu.parallel.batch import batched_nr_solve_f32
from juliagrid_tpu.powerflow.ac import compile_ac_arrays

HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)


def _sub_jaxprs(value):
    if isinstance(value, jax.extend.core.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jax.extend.core.Jaxpr):
        yield value
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _sub_jaxprs(v)


def _f32_dots(jaxpr):
    """Every dot_general with an f32 operand, in all nested jaxprs."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general" and any(
                v.aval.dtype == jnp.float32 for v in eqn.invars):
            yield eqn
        for value in eqn.params.values():
            for sub in _sub_jaxprs(value):
                yield from _f32_dots(sub)


def _se_inputs(data_path):
    system = jg.power_system(str(data_path / "case14test.m"))
    pf = jg.newton_raphson(system)
    jg.power_flow(pf, power=True)
    mon = jg.measurement(system)
    jg.add_voltmeter(mon, analysis=pf, noise=False)
    jg.add_wattmeter(mon, analysis=pf, noise=False)
    jg.add_varmeter(mon, analysis=pf, noise=False)
    arr, _, _ = compile_se_arrays(system, mon)
    n = system.bus.number
    return arr, compile_ac_arrays(system), jnp.ones(n), jnp.zeros(n)


def _rand(shape, dtype=jnp.float64, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape)
    return jnp.asarray(a, dtype=dtype)


def _traced(target, data_path):
    if target.startswith("gn_increment_"):
        kind = target.removeprefix("gn_increment_")
        arr, net, vm, va = _se_inputs(data_path)
        return jax.make_jaxpr(
            lambda vm, va: gn_increment(arr, net, vm, va, kind))(vm, va)
    if target == "pw_lsq_solve":
        return jax.make_jaxpr(linalg.pw_lsq_solve)(
            _rand((40, 12)), _rand(40, seed=1))
    if target.startswith("solve_f32_"):
        kind = target.removeprefix("solve_f32_")
        a = _rand((16, 16), jnp.float32) + 8.0 * jnp.eye(16)
        a = a @ a.T if kind == linalg.LL else a
        return jax.make_jaxpr(
            lambda a, b: linalg.solve(linalg.factorize(a, kind), b))(
                a, _rand(16, jnp.float32, seed=1))
    if target == "batched_nr_solve_f32":
        system = jg.power_system(str(data_path / "case14.m"))
        arr = compile_ac_arrays(system)
        n = system.bus.number
        ones = jnp.ones((2, n))
        return jax.make_jaxpr(
            lambda vm, va, p, q: batched_nr_solve_f32(arr, vm, va, p, q))(
                ones, 0.0 * ones, jnp.stack([arr.p_sched] * 2),
                jnp.stack([arr.q_sched] * 2))
    raise ValueError(target)


@pytest.mark.parametrize("target", [
    "gn_increment_LU", "gn_increment_QR", "gn_increment_PW",
    "pw_lsq_solve", "solve_f32_LU", "solve_f32_QR", "solve_f32_LL",
    "batched_nr_solve_f32"])
def test_f32_products_are_highest(target, data_path):
    dots = list(_f32_dots(_traced(target, data_path).jaxpr))
    assert dots, f"{target} forms no f32 product; the test lost its subject"
    loose = [d for d in dots if d.params["precision"] != HIGHEST]
    assert not loose, [str(d) for d in loose]


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda "
                    "python -m pytest -m gpu tests/")
    return jax.devices()[0]


@pytest.mark.gpu
def test_gpu_qr_solve_keeps_f32_accuracy(gpu):
    """The QR path's f32 product qᵀb keeps f32 accuracy on the card; a
    TF32 product would leave a relative error near 1e-3."""
    a = np.random.default_rng(0).standard_normal((512, 512)) \
        + 100.0 * np.eye(512)
    b = np.random.default_rng(1).standard_normal(512)
    x = jax.jit(lambda a, b: linalg._solve_f32(
        linalg.QR, jnp.linalg.qr(a), b))(
            jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32))
    ref = np.linalg.solve(a, b)
    assert np.max(np.abs(np.asarray(x) - ref)) / np.max(np.abs(ref)) < 1e-5
