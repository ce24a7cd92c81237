"""Fast Newton-Raphson (fast decoupled) power flow, BX and XB variants.

Reference: /root/reference/src/powerFlow/acPowerFlow.jl:215-483 (model and
constant B'/B'' Jacobians), :698-730 (V-scaled mismatches), :913-983 (the
half-iteration scheme: P-solve, angle update, fresh Q mismatch, Q-solve).

Design: B' and B'' are constant, so they are masked to full n x n
(identity on slack / non-PQ rows) and factorized ONCE in f32 at
construction; every iteration is then two triangular-solve + refinement
passes and one vectorized mismatch evaluation — no per-iteration
factorization at all. This is the amortization the reference gets from
KLU refactorization.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np
import scipy.sparse as sp

from ..ops import linalg
from ..system.model import model
from ..system.types import PowerSystem
from .ac import (AcPowerFlow, MethodState, Polar, _injections,
                 compile_ac_arrays, initialize_ac_power_flow)


class FnrArrays(NamedTuple):
    rows: jax.Array
    cols: jax.Array
    yg: jax.Array
    yb: jax.Array
    diag: jax.Array
    bus_type: jax.Array
    slack: jax.Array
    p_sched: jax.Array
    q_sched: jax.Array
    # constant factorized Jacobians (f32 LU) + f64 originals for refinement
    bp_lu: jax.Array
    bp_piv: jax.Array
    bp_a64: jax.Array
    bq_lu: jax.Array
    bq_piv: jax.Array
    bq_a64: jax.Array


def _fnr_matrices(system: PowerSystem, bx: bool):
    """Build masked-dense B' and B'' (reference fastNewtonJacobian!/
    jacobianCoefficient, acPowerFlow.jl:416-483)."""
    n = system.bus.number
    m = system.branch.number
    prm = system.branch.parameter
    f = system.branch.layout.from_bus.array[:m]
    t = system.branch.layout.to_bus.array[:m]
    on = system.branch.layout.status.array[:m] == 1

    r = prm.resistance.array[:m]
    x = prm.reactance.array[:m]
    bsi = 0.5 * prm.susceptance.array[:m]
    tau_inv = 1.0 / prm.turns_ratio.array[:m]
    phi = prm.shift_angle.array[:m]
    sin_p, cos_p = np.sin(phi), np.cos(phi)

    y = np.where(on, 1.0 / (r + 1j * x), 0.0)
    if bx:
        bmk = np.where(on, -1.0 / x, 0.0)
        p_a, p_b = y.real, y.imag
    else:
        bmk = y.imag
        p_a = np.zeros(m)
        p_b = np.where(on, -1.0 / x, 0.0)

    denom = cos_p**2 + sin_p**2
    pij = np.where(on, (-p_a * sin_p - p_b * cos_p) / denom, 0.0)
    pji = np.where(on, (p_a * sin_p - p_b * cos_p) / denom, 0.0)
    pii = np.where(on, p_b / denom, 0.0)
    pjj = np.where(on, p_b, 0.0)

    q_a = -bmk * tau_inv
    q_b = (bmk + bsi) * tau_inv**2
    q_c = bmk + bsi
    q_a = np.where(on, q_a, 0.0)
    q_b = np.where(on, q_b, 0.0)
    q_c = np.where(on, q_c, 0.0)

    bp = np.zeros((n, n))
    bq = np.zeros((n, n))
    np.add.at(bp, (f, t), pij)
    np.add.at(bp, (t, f), pji)
    np.add.at(bp, (f, f), pii)
    np.add.at(bp, (t, t), pjj)
    np.add.at(bq, (f, t), q_a)
    np.add.at(bq, (t, f), q_a)
    np.add.at(bq, (f, f), q_b)
    np.add.at(bq, (t, t), q_c)

    # PQ-bus shunt susceptance correction (acPowerFlow.jl:328-334)
    bus_b = system.bus.shunt.susceptance.array[:n]
    bq[np.arange(n), np.arange(n)] += bus_b

    types = system.bus.layout.type.array[:n]
    slack = system.bus.layout.slack
    m_p = (np.arange(n) != slack).astype(np.float64)
    m_q = (types == 1).astype(np.float64)
    bp = m_p[:, None] * bp * m_p[None, :] + np.diag(1.0 - m_p)
    bq = m_q[:, None] * bq * m_q[None, :] + np.diag(1.0 - m_q)
    return bp, bq


@jax.jit
def _lu32(a64):
    lu, piv = jsl.lu_factor(a64.astype(jnp.float32))
    return lu, piv


def compile_fnr_arrays(system: PowerSystem, bx: bool) -> FnrArrays:
    base = compile_ac_arrays(system)
    bp, bq = _fnr_matrices(system, bx)
    bp64 = jnp.asarray(bp)
    bq64 = jnp.asarray(bq)
    bp_lu, bp_piv = _lu32(bp64)
    bq_lu, bq_piv = _lu32(bq64)
    return FnrArrays(
        rows=base.rows, cols=base.cols, yg=base.yg, yb=base.yb,
        diag=base.diag, bus_type=base.bus_type, slack=base.slack,
        p_sched=base.p_sched, q_sched=base.q_sched,
        bp_lu=bp_lu, bp_piv=bp_piv, bp_a64=bp64,
        bq_lu=bq_lu, bq_piv=bq_piv, bq_a64=bq64,
    )


def _refined_lu_solve(lu, piv, a64, b64, refine: int = 3):
    x = jsl.lu_solve((lu, piv), b64.astype(jnp.float32)).astype(b64.dtype)

    def body(_, x):
        r = b64 - a64 @ x
        return x + jsl.lu_solve(
            (lu, piv), r.astype(jnp.float32)).astype(b64.dtype)

    return jax.lax.fori_loop(0, refine, body, x)


def _fnr_mismatch_pair(arr: FnrArrays, vm, va):
    """V-scaled active/reactive mismatches (acPowerFlow.jl:698-730)."""
    n = vm.shape[0]
    p, q, _, _ = _injections(arr, vm, va)
    not_slack = jnp.arange(n) != arr.slack
    is_pq = arr.bus_type == 1
    mp = jnp.where(not_slack, (p - arr.p_sched) / vm, 0.0)
    mq = jnp.where(is_pq, (q - arr.q_sched) / vm, 0.0)
    del_p = jnp.max(jnp.abs(mp))
    del_q = jnp.max(jnp.abs(mq))
    return mp, mq, del_p, del_q


_fnr_mismatch_jit = jax.jit(_fnr_mismatch_pair)


@partial(jax.jit, static_argnames=("kind", "max_iter"))
def _fnr_solve(arr: FnrArrays, vm, va, tol: float, max_iter: int,
               kind: str = "LU"):
    n = vm.shape[0]
    not_slack = jnp.arange(n) != arr.slack
    is_pq = arr.bus_type == 1

    mp, mq, del_p, del_q = _fnr_mismatch_pair(arr, vm, va)

    def cond(carry):
        vm, va, it, del_p, del_q, mp = carry
        return (~((del_p < tol) & (del_q < tol))) & (it < max_iter)

    def body(carry):
        vm, va, it, _, _, mp = carry
        # P half-iteration
        dva = _refined_lu_solve(arr.bp_lu, arr.bp_piv, arr.bp_a64, mp)
        va = va + jnp.where(not_slack, dva, 0.0)
        # fresh reactive mismatch at updated angles (acPowerFlow.jl:959-970)
        p, q, _, _ = _injections(arr, vm, va)
        mq = jnp.where(is_pq, (q - arr.q_sched) / vm, 0.0)
        dvm = _refined_lu_solve(arr.bq_lu, arr.bq_piv, arr.bq_a64, mq)
        vm = vm + jnp.where(is_pq, dvm, 0.0)
        it = it + 1
        mp, mq, del_p, del_q = _fnr_mismatch_pair(arr, vm, va)
        return vm, va, it, del_p, del_q, mp

    vm, va, it, del_p, del_q, mp = jax.lax.while_loop(
        cond, body, (vm, va, jnp.int64(0), del_p, del_q, mp))
    converged = (del_p < tol) & (del_q < tol)
    return vm, va, it, del_p, del_q, converged


def fast_newton_raphson_bx(system: PowerSystem,
                           factorization: str = linalg.LU) -> AcPowerFlow:
    return _fast_newton_raphson(system, True, factorization)


def fast_newton_raphson_xb(system: PowerSystem,
                           factorization: str = linalg.LU) -> AcPowerFlow:
    return _fast_newton_raphson(system, False, factorization)


def _fast_newton_raphson(system, bx: bool, factorization: str) -> AcPowerFlow:
    system.check_slack()
    model(system, "ac")
    magnitude, angle = initialize_ac_power_flow(system)
    arrays = compile_fnr_arrays(system, bx)
    rev = system.model.revision
    name = "fast_newton_raphson_bx" if bx else "fast_newton_raphson_xb"
    return AcPowerFlow(
        system=system,
        voltage=Polar(magnitude, angle),
        method=MethodState(name, factorization),
        arrays=arrays,
        signature={"ac_model": rev.ac_model, "ac_pattern": rev.ac_pattern,
                   "type": rev.type, "injection": rev.injection,
                   "slack": rev.slack},
    )


def fnr_mismatch(analysis: AcPowerFlow):
    vm = jnp.asarray(analysis.voltage.magnitude)
    va = jnp.asarray(analysis.voltage.angle)
    _, _, del_p, del_q = _fnr_mismatch_jit(analysis.arrays, vm, va)
    analysis.method.max_mismatch_active = float(del_p)
    analysis.method.max_mismatch_reactive = float(del_q)
    return float(del_p), float(del_q)


@jax.jit
def _fnr_one_step(arr: FnrArrays, vm, va):
    n = vm.shape[0]
    not_slack = jnp.arange(n) != arr.slack
    is_pq = arr.bus_type == 1
    mp, _, _, _ = _fnr_mismatch_pair(arr, vm, va)
    dva = _refined_lu_solve(arr.bp_lu, arr.bp_piv, arr.bp_a64, mp)
    va = va + jnp.where(not_slack, dva, 0.0)
    p, q, _, _ = _injections(arr, vm, va)
    mq = jnp.where(is_pq, (q - arr.q_sched) / vm, 0.0)
    dvm = _refined_lu_solve(arr.bq_lu, arr.bq_piv, arr.bq_a64, mq)
    vm = vm + jnp.where(is_pq, dvm, 0.0)
    return vm, va


def fnr_solve_step(analysis: AcPowerFlow):
    vm = jnp.asarray(analysis.voltage.magnitude)
    va = jnp.asarray(analysis.voltage.angle)
    vm, va = _fnr_one_step(analysis.arrays, vm, va)
    analysis.voltage.magnitude = np.asarray(vm)
    analysis.voltage.angle = np.asarray(va)
    analysis.method.iteration += 1


# ---------------------------------------------------------------------------
# Fast decoupled on the BBD substrate (constant factors amortize perfectly)
# ---------------------------------------------------------------------------

def _fnr_matrices_sparse(system: PowerSystem, bx: bool):
    """Sparse-CSR B'/B'' (same coefficients as ``_fnr_matrices``) for the
    BBD scale path: no dense n x n host intermediate."""
    n = system.bus.number
    m = system.branch.number
    prm = system.branch.parameter
    f = system.branch.layout.from_bus.array[:m]
    t = system.branch.layout.to_bus.array[:m]
    on = system.branch.layout.status.array[:m] == 1

    r = prm.resistance.array[:m]
    x = prm.reactance.array[:m]
    bsi = 0.5 * prm.susceptance.array[:m]
    tau_inv = 1.0 / prm.turns_ratio.array[:m]
    phi = prm.shift_angle.array[:m]
    sin_p, cos_p = np.sin(phi), np.cos(phi)

    y = np.where(on, 1.0 / (r + 1j * x), 0.0)
    if bx:
        bmk = np.where(on, -1.0 / x, 0.0)
        p_a, p_b = y.real, y.imag
    else:
        bmk = y.imag
        p_a = np.zeros(m)
        p_b = np.where(on, -1.0 / x, 0.0)

    denom = cos_p**2 + sin_p**2
    pij = np.where(on, (-p_a * sin_p - p_b * cos_p) / denom, 0.0)
    pji = np.where(on, (p_a * sin_p - p_b * cos_p) / denom, 0.0)
    pii = np.where(on, p_b / denom, 0.0)
    pjj = np.where(on, p_b, 0.0)
    q_a = np.where(on, -bmk * tau_inv, 0.0)
    q_b = np.where(on, (bmk + bsi) * tau_inv**2, 0.0)
    q_c = np.where(on, bmk + bsi, 0.0)

    rows = np.concatenate([f, t, f, t])
    cols = np.concatenate([t, f, f, t])
    bp = sp.coo_matrix((np.concatenate([pij, pji, pii, pjj]),
                        (rows, cols)), shape=(n, n)).tocsr()
    bq = sp.coo_matrix((np.concatenate([q_a, q_a, q_b, q_c]),
                        (rows, cols)), shape=(n, n)).tocsr()
    bq = bq + sp.diags(system.bus.shunt.susceptance.array[:n])

    types = system.bus.layout.type.array[:n]
    slack = system.bus.layout.slack
    m_p = (np.arange(n) != slack).astype(np.float64)
    m_q = (types == 1).astype(np.float64)
    bp = sp.diags(m_p) @ bp @ sp.diags(m_p) + sp.diags(1.0 - m_p)
    bq = sp.diags(m_q) @ bq @ sp.diags(m_q) + sp.diags(1.0 - m_q)
    return bp.tocsr(), bq.tocsr()


def compile_fnr_bbd(system: PowerSystem, bx: bool, n_blocks: int):
    """Device snapshot + precomputed BBD factors for the fast-decoupled
    BBD path; shared by construction and the signature-refresh protocol."""
    from ..ops.bbd import bbd_precompute, build_bbd_arrays
    from ..ops.partition import nd_partition
    from ..system.model import model as _model

    _model(system, "ac")
    base = compile_ac_arrays(system)
    bp, bq = _fnr_matrices_sparse(system, bx)
    # partition on the stored pattern (incl. structural zeros) so the
    # B'/B'' entries — whose pattern is a subset of it — never cross blocks
    nodal = system.model.ac.nodal.tocsr()
    pattern = sp.csr_matrix(
        (np.ones(nodal.nnz), nodal.indices, nodal.indptr), shape=nodal.shape)
    block_of, border = nd_partition(pattern, n_blocks)
    f_p = bbd_precompute(build_bbd_arrays(bp, block_of, border))
    f_q = bbd_precompute(build_bbd_arrays(bq, block_of, border))
    return base, (f_p, f_q)


def fast_newton_raphson_bbd(system: PowerSystem, bx: bool = True,
                            n_blocks: int = 4) -> AcPowerFlow:
    """Fast-decoupled PF with B'/B'' factorized once in BBD form —
    the large-network variant of fast_newton_raphson_bx/xb."""
    system.check_slack()
    magnitude, angle = initialize_ac_power_flow(system)
    base, factors = compile_fnr_bbd(system, bx, n_blocks)

    rev = system.model.revision
    name = "fast_newton_raphson_bbd_bx" if bx \
        else "fast_newton_raphson_bbd_xb"
    analysis = AcPowerFlow(
        system=system,
        voltage=Polar(magnitude, angle),
        method=MethodState(name),
        arrays=base,
        signature={"ac_model": rev.ac_model, "ac_pattern": rev.ac_pattern,
                   "type": rev.type, "injection": rev.injection,
                   "slack": rev.slack},
    )
    analysis._bbd_factors = factors
    analysis._bbd_n_blocks = n_blocks
    return analysis


@partial(jax.jit, static_argnames="max_iter")
def _fnr_bbd_solve(arr, f_p, f_q, vm, va, tol, max_iter):
    from ..ops.bbd import bbd_presolved_solve

    n = vm.shape[0]
    not_slack = jnp.arange(n) != arr.slack
    is_pq = arr.bus_type == 1

    def mism(vm, va):
        p, q, _, _ = _injections(arr, vm, va)
        mp = jnp.where(not_slack, (p - arr.p_sched) / vm, 0.0)
        mq = jnp.where(is_pq, (q - arr.q_sched) / vm, 0.0)
        return mp, mq, jnp.max(jnp.abs(mp)), jnp.max(jnp.abs(mq))

    mp, mq, del_p, del_q = mism(vm, va)

    def cond(carry):
        vm, va, it, del_p, del_q, mp = carry
        return (~((del_p < tol) & (del_q < tol))) & (it < max_iter)

    def body(carry):
        vm, va, it, _, _, mp = carry
        dva = bbd_presolved_solve(f_p, mp)
        va = va + jnp.where(not_slack, dva, 0.0)
        p, q, _, _ = _injections(arr, vm, va)
        mq = jnp.where(is_pq, (q - arr.q_sched) / vm, 0.0)
        dvm = bbd_presolved_solve(f_q, mq)
        vm = vm + jnp.where(is_pq, dvm, 0.0)
        mp, mq, del_p, del_q = mism(vm, va)
        return vm, va, it + 1, del_p, del_q, mp

    vm, va, it, del_p, del_q, mp = jax.lax.while_loop(
        cond, body, (vm, va, jnp.int64(0), del_p, del_q, mp))
    return vm, va, it, del_p, del_q, (del_p < tol) & (del_q < tol)


def power_flow_fnr_bbd(analysis: AcPowerFlow, iteration: int = 30,
                       tolerance: float = 1e-8):
    analysis._refresh_arrays()
    f_p, f_q = analysis._bbd_factors
    vm = jnp.asarray(analysis.voltage.magnitude)
    va = jnp.asarray(analysis.voltage.angle)
    vm, va, it, del_p, del_q, conv = _fnr_bbd_solve(
        analysis.arrays, f_p, f_q, vm, va, tolerance, iteration)
    analysis.voltage.magnitude = np.asarray(vm)
    analysis.voltage.angle = np.asarray(va)
    analysis.method.iteration = int(it)
    analysis.method.converged = bool(conv)
    analysis.method.max_mismatch_active = float(del_p)
    analysis.method.max_mismatch_reactive = float(del_q)
    return analysis
