"""Checkpoint/resume for long batched runs + the profiling surface
(SURVEY §5 aux rows: checkpoint/resume, tracing/profiling)."""

import numpy as np
import pytest

import juliagrid_tpu as jg
from juliagrid_tpu.utils.checkpoint import (checkpointed_map,
                                            load_checkpoint,
                                            save_checkpoint)
from juliagrid_tpu.utils.profiling import Timings, default_timings, span


def test_checkpoint_roundtrip(tmp_path):
    path = str(tmp_path / "ck.h5")
    tree = {"a": np.arange(5.0), "nest": [np.eye(2), (np.zeros(3), 7)]}
    save_checkpoint(path, tree, step=3, meta={"n_items": 10})
    step, loaded, meta = load_checkpoint(path)
    assert step == 3 and int(meta["n_items"]) == 10
    np.testing.assert_array_equal(loaded["a"], tree["a"])
    np.testing.assert_array_equal(loaded["nest"][0], np.eye(2))
    assert isinstance(loaded["nest"][1], tuple)
    assert int(loaded["nest"][1][1]) == 7


def test_checkpointed_map_resumes_without_recompute(tmp_path):
    path = str(tmp_path / "fleet.h5")
    calls = []

    def fn(start, stop):
        calls.append(start)
        if len(calls) == 3 and not getattr(fn, "resumed", False):
            raise RuntimeError("simulated preemption")
        return {"sum": np.arange(start, stop).sum()}

    with pytest.raises(RuntimeError):
        checkpointed_map(fn, 10, 2, path, every=1)
    assert calls == [0, 2, 4]  # chunks 0 and 2 are checkpointed

    fn.resumed = True
    results = checkpointed_map(fn, 10, 2, path, every=1)
    # only the 3 missing chunks ran on resume
    assert calls == [0, 2, 4, 4, 6, 8]
    assert [int(r["sum"]) for r in results] == [1, 5, 9, 13, 17]


def test_checkpointed_map_rejects_different_slicing(tmp_path):
    path = str(tmp_path / "fleet.h5")
    checkpointed_map(lambda a, b: {"x": np.zeros(1)}, 4, 2, path)
    with pytest.raises(ValueError):
        checkpointed_map(lambda a, b: {"x": np.zeros(1)}, 4, 1, path)


def test_checkpointed_se_fleet_matches_uninterrupted(tmp_path):
    """The advertised use: a chunked Monte-Carlo SE fleet interrupted and
    resumed produces the same estimates as one uninterrupted run."""
    import jax.numpy as jnp

    from juliagrid_tpu.estimation.acse import compile_se_arrays
    from juliagrid_tpu.parallel.batch import batched_se_solve_jit
    from juliagrid_tpu.powerflow.ac import compile_ac_arrays

    system = jg.power_system("tests/data/case14test.m")
    pf = jg.newton_raphson(system)
    jg.power_flow(pf, power=True)
    mon = jg.measurement(system)
    jg.add_voltmeter(mon, analysis=pf, noise=False)
    jg.add_wattmeter(mon, analysis=pf, noise=False)
    jg.add_varmeter(mon, analysis=pf, noise=False)
    arr, _, _, arr_h = compile_se_arrays(system, mon, return_host=True)
    net = compile_ac_arrays(system)
    n = system.bus.number

    rng = np.random.default_rng(7)
    base = np.asarray(arr_h.mean)
    sigma = 1.0 / np.sqrt(np.asarray(arr_h.w))
    means = base[None, :] + 0.1 * sigma * rng.standard_normal(
        (8, len(base)))
    chunk = 2
    vm0 = jnp.asarray(np.tile(system.bus.voltage.magnitude.array[:n],
                              (chunk, 1)))
    va0 = jnp.asarray(np.tile(system.bus.voltage.angle.array[:n],
                              (chunk, 1)))

    def solve_chunk(start, stop):
        vm, va, iters, conv = batched_se_solve_jit(
            arr, net, vm0, va0, jnp.asarray(means[start:stop]),
            tol=1e-8, max_iter=40)
        return {"vm": np.asarray(vm), "conv": np.asarray(conv)}

    direct = [solve_chunk(s, s + chunk) for s in range(0, 8, chunk)]

    path = str(tmp_path / "se.h5")
    boom = {"left": 2}

    def flaky(start, stop):
        if start >= 4 and boom["left"] > 0:
            boom["left"] -= 1
            raise RuntimeError("preempted")
        return solve_chunk(start, stop)

    for _ in range(2):
        with pytest.raises(RuntimeError):
            checkpointed_map(flaky, 8, chunk, path)
    resumed = checkpointed_map(flaky, 8, chunk, path)
    for d, r in zip(direct, resumed):
        np.testing.assert_allclose(r["vm"], d["vm"], atol=1e-12)
        assert r["conv"].all()


def test_timings_spans_and_report():
    t = Timings()
    with t.span("phase_a"):
        pass
    with t.span("phase_a"):
        pass
    with t.span("phase_b"):
        pass
    assert t.spans["phase_a"][0] == 2
    rep = t.report()
    assert "phase_a" in rep and "Calls" in rep

    with span("global_phase"):
        pass
    assert default_timings.spans["global_phase"][0] >= 1


def test_drivers_record_timings():
    system = jg.power_system("tests/data/case14test.m")
    pf = jg.newton_raphson(system)
    jg.power_flow(pf, power=True)
    assert pf.method.timings.spans["solve"][0] == 1
    assert pf.method.timings.total("solve") > 0

    mon = jg.measurement(system)
    jg.add_voltmeter(mon, analysis=pf, noise=False)
    jg.add_wattmeter(mon, analysis=pf, noise=False)
    jg.add_varmeter(mon, analysis=pf, noise=False)
    se = jg.gauss_newton(mon)
    jg.state_estimation(se)
    assert se.method.timings.total("solve") > 0


def test_trace_writes_a_device_trace(tmp_path):
    import jax.numpy as jnp

    from juliagrid_tpu.utils.profiling import trace

    with trace(str(tmp_path)):
        jnp.ones(8).sum().block_until_ready()
    assert list(tmp_path.rglob("*.xplane.pb"))


def test_trace_failure_raises(tmp_path):
    """A profiler that cannot start raises; nothing runs untraced."""
    from juliagrid_tpu.utils.profiling import trace

    with trace(str(tmp_path / "outer")):
        with pytest.raises(RuntimeError):
            with trace(str(tmp_path / "inner")):
                pass
