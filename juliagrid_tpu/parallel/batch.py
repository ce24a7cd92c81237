"""Scenario batching and device-mesh sharding.

The reference is single-threaded, single-process (SURVEY §5): its users run
scenario studies by re-running scripts. Here the scenario axis is a
first-class array dimension:

  * within one device: ``jax.vmap`` over the solver cores (mismatch/
    Jacobian assembly become batched segment-sums, the factorizations
    become batched dense factorizations and matmuls);
  * across devices: ``NamedSharding`` over a ``Mesh`` with a ``scenario``
    axis — XLA partitions the batched program with zero cross-device
    communication except the final convergence reductions, which run as
    ``psum``-style collectives.

Network-block (BBD/Schur) sharding for single giant cases is the ``block``
mesh axis; see ops/bbd.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..powerflow.ac import AcArrays, _mismatch, _nr_step


def batched_nr_solve(arr: AcArrays, vm0, va0, p_sched, q_sched,
                     tol: float = 1e-8, max_iter: int = 20):
    """Batched Newton-Raphson over scenarios.

    ``vm0, va0, p_sched, q_sched`` carry a leading scenario axis; the
    network (Y-bus pattern/values) is shared. All scenarios iterate in
    lockstep inside one ``lax.while_loop`` until every scenario converges
    or hits the cap — the batched equivalent of the reference driver loop.
    Returns (vm, va, iterations, converged) with per-scenario counts.
    """

    def one_mismatch(vm, va, ps, qs):
        a = arr._replace(p_sched=ps, q_sched=qs)
        _, _, dp, dq = _mismatch(a, vm, va)
        return dp, dq

    def one_step(vm, va, ps, qs):
        a = arr._replace(p_sched=ps, q_sched=qs)
        return _nr_step(a, vm, va, "LU")

    v_mismatch = jax.vmap(one_mismatch)
    v_step = jax.vmap(one_step)

    dp, dq = v_mismatch(vm0, va0, p_sched, q_sched)
    active0 = ~((dp < tol) & (dq < tol))

    def cond(carry):
        vm, va, it, active, iters = carry
        return jnp.any(active) & (it < max_iter)

    def body(carry):
        vm, va, it, active, iters = carry
        vm_new, va_new = v_step(vm, va, p_sched, q_sched)
        # only scenarios that are still active advance
        vm = jnp.where(active[:, None], vm_new, vm)
        va = jnp.where(active[:, None], va_new, va)
        iters = iters + active.astype(iters.dtype)
        dp, dq = v_mismatch(vm, va, p_sched, q_sched)
        active = active & ~((dp < tol) & (dq < tol))
        return vm, va, it + 1, active, iters

    nscen = vm0.shape[0]
    iters0 = jnp.zeros(nscen, dtype=jnp.int32)
    vm, va, it, active, iters = jax.lax.while_loop(
        cond, body, (vm0, va0, jnp.int32(0), active0, iters0))
    return vm, va, iters, ~active


batched_nr_solve_jit = jax.jit(batched_nr_solve,
                               static_argnames=("tol", "max_iter"))


def scenario_mesh(n_devices: int | None = None, axis: str = "scenario"):
    """Build a 1-D device mesh over the scenario axis."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def shard_scenarios(mesh: Mesh, *arrays, axis: str = "scenario"):
    """Place scenario-batched arrays with the leading axis sharded."""
    sharding = NamedSharding(mesh, P(axis))
    return tuple(jax.device_put(a, sharding) for a in arrays)


def sharded_nr_solve(mesh: Mesh, arr: AcArrays, vm0, va0, p_sched, q_sched,
                     tol: float = 1e-8, max_iter: int = 20):
    """Scenario-sharded batched NR over the mesh.

    The network snapshot is replicated; scenario states are sharded on the
    leading axis. XLA inserts the (tiny) collectives for the global
    convergence test in the while_loop condition.
    """
    repl = NamedSharding(mesh, P())
    shard = NamedSharding(mesh, P("scenario"))
    arr = jax.device_put(arr, repl)
    vm0, va0, p_sched, q_sched = (
        jax.device_put(x, shard) for x in (vm0, va0, p_sched, q_sched))
    return batched_nr_solve_jit(arr, vm0, va0, p_sched, q_sched,
                                tol=tol, max_iter=max_iter)


# ---------------------------------------------------------------------------
# Batched WLS state estimation (Monte-Carlo measurement sets)
# ---------------------------------------------------------------------------

def batched_se_solve(arr, net, vm0, va0, means,
                     tol: float = 1e-8, max_iter: int = 40):
    """Batched Gauss-Newton WLS over scenario measurement means.

    ``means`` has shape (scenarios, rows); the measurement pattern, weights
    and network are shared, so the H-build and gain formation vectorize into
    batched matmuls. This is the BASELINE "10k-scenario Monte-Carlo SE"
    configuration: shard the leading axis over the mesh to scale out;
    ``se_chunk_size`` sizes the scenario chunks that fit one device.
    """
    from ..estimation.acse import gn_increment

    def one_increment(mean, vm, va):
        a = arr._replace(mean=mean)
        return gn_increment(a, net, vm, va, "LU")

    v_inc = jax.vmap(one_increment)

    n = vm0.shape[1]
    dx, maxinc, rel = v_inc(means, vm0, va0)
    active0 = maxinc >= tol

    def cond(carry):
        vm, va, dx, active, relmax, iters, it = carry
        return jnp.any(active) & (it < max_iter)

    def body(carry):
        vm, va, dx, active, relmax, iters, it = carry
        va = jnp.where(active[:, None], va + dx[:, :n], va)
        vm = jnp.where(active[:, None], vm + dx[:, n:], vm)
        iters = iters + active.astype(iters.dtype)
        dx, maxinc, rel = v_inc(means, vm, va)
        relmax = jnp.where(active, jnp.maximum(relmax, rel), relmax)
        active = active & (maxinc >= tol)
        return vm, va, dx, active, relmax, iters, it + 1

    nscen = vm0.shape[0]
    vm, va, dx, active, relmax, iters, it = jax.lax.while_loop(
        cond, body,
        (vm0, va0, dx, active0, rel, jnp.zeros(nscen, dtype=jnp.int32),
         jnp.int32(0)))
    # a lane whose refinement gate tripped (f32 gain too ill-conditioned
    # to refine) is NOT a trustworthy solve: report it unconverged so the
    # caller can route it through the QR path instead of trusting it
    return vm, va, iters, ~active & (relmax <= 1e-6)


batched_se_solve_jit = jax.jit(batched_se_solve,
                               static_argnames=("tol", "max_iter"))


def sharded_se_solve(mesh: Mesh, arr, net, vm0, va0, means,
                     tol: float = 1e-8, max_iter: int = 40):
    """Scenario-sharded batched WLS SE over the device mesh."""
    repl = NamedSharding(mesh, P())
    shard = NamedSharding(mesh, P("scenario"))
    arr = jax.device_put(arr, repl)
    net = jax.device_put(net, repl)
    vm0, va0, means = (jax.device_put(x, shard) for x in (vm0, va0, means))
    return batched_se_solve_jit(arr, net, vm0, va0, means,
                                tol=tol, max_iter=max_iter)


def se_chunk_size(rows: int, n_bus: int, bytes_limit: int,
                  cap: int = 256) -> int:
    """Largest power-of-two scenario chunk of ``batched_se_solve`` whose
    estimated footprint fits a quarter of ``bytes_limit`` (the device's
    ``memory_stats()["bytes_limit"]``; the rest is headroom for XLA's
    temporaries). Per scenario: the f32 dense H and its weight-scaled copy
    (2 x rows x 2n) plus ~3 f32 (2n)^2 gain/LU/temporaries."""
    s = 2 * n_bus
    per_scenario = 4 * (2 * rows * s + 3 * s * s)
    chunk = cap
    while chunk > 1 and chunk * per_scenario > bytes_limit // 4:
        chunk //= 2
    return chunk


# ---------------------------------------------------------------------------
# f32 fast path: screening fleets at relaxed tolerance
# ---------------------------------------------------------------------------

def batched_nr_solve_f32(arr: AcArrays, vm0, va0, p_sched, q_sched,
                         tol: float = 1e-5, max_iter: int = 20):
    """Newton-Raphson fleet in pure f32 (the refinement products run in
    f32 at ``Precision.HIGHEST``).

    Halves the state and network bytes of the f64 fleet. Converges to
    ~1e-5 mismatch — the screening mode; rerun suspicious scenarios
    through the f64 path.
    """
    arr32 = arr._replace(
        yg=arr.yg.astype(jnp.float32), yb=arr.yb.astype(jnp.float32),
        p_sched=arr.p_sched.astype(jnp.float32),
        q_sched=arr.q_sched.astype(jnp.float32))
    return batched_nr_solve(
        arr32, vm0.astype(jnp.float32), va0.astype(jnp.float32),
        p_sched.astype(jnp.float32), q_sched.astype(jnp.float32),
        tol=tol, max_iter=max_iter)


batched_nr_solve_f32_jit = jax.jit(batched_nr_solve_f32,
                                   static_argnames=("tol", "max_iter"))


# ---------------------------------------------------------------------------
# Batched DC power flow: factorize once, batch the triangular solves
# ---------------------------------------------------------------------------

def batched_dc_solve(arr, p_sched, method: str = "LU"):
    """Batched DC power flow over demand/injection scenarios.

    ``arr`` is a ``DcArrays`` snapshot (powerflow/dc.py); ``p_sched`` is
    f64[nscen, n] scheduled injections. The (shared) slack-masked B'
    matrix is factorized ONCE and the per-scenario triangular
    solves are batched — the amortization the constant DC matrix exists
    for (the reference re-factorizes per run, dcPowerFlow.jl:165-193).

    Returns f64[nscen, n] bus angles.
    """
    from ..ops import linalg as _lin

    n = arr.b_dense.shape[0]
    m = (jnp.arange(n) != arr.slack).astype(arr.b_dense.dtype)
    b = m[:, None] * arr.b_dense * m[None, :] + jnp.diag(1.0 - m)
    fac = _lin.factorize(b, method)
    rhs = (p_sched - arr.shift[None, :] - arr.gshunt[None, :]) * m[None, :]
    theta = jax.vmap(lambda r: _lin.solve(fac, r))(rhs)
    return theta + arr.slack_angle


batched_dc_solve_jit = jax.jit(batched_dc_solve, static_argnames="method")
