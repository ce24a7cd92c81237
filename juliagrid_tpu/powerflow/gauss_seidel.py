"""Gauss-Seidel AC power flow.

Reference: /root/reference/src/powerFlow/acPowerFlow.jl:563-619 (setup),
:732-764 (mismatch on PQ/PV buses), :985-1041 (sequential sweep: PQ update,
PV update with computed reactive injection, PV magnitude re-projection).

The per-bus sweep is inherently sequential; on the device it runs as a
``lax.fori_loop`` over a padded per-bus neighbor table (static shapes,
gather + masked dot per step). Complex arithmetic is carried as explicit
(re, im) f64 pairs. This method exists for capability parity — the NR and
fast-decoupled paths are the performance paths.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import linalg
from ..system.model import model
from ..system.types import PowerSystem
from .ac import (AcPowerFlow, MethodState, Polar, compile_ac_arrays,
                 initialize_ac_power_flow)


class GsArrays(NamedTuple):
    nb: jax.Array       # i32[n, dmax] padded neighbor indices (row pattern)
    yre: jax.Array      # f64[n, dmax] Re(Y row), 0-padded
    yim: jax.Array      # f64[n, dmax]
    dre: jax.Array      # f64[n] Re(Y_ii)
    dim: jax.Array      # f64[n]
    bus_type: jax.Array
    slack: jax.Array
    p_sched: jax.Array
    q_sched: jax.Array
    vg: jax.Array       # f64[n] PV magnitude setpoint (1.0 elsewhere)


def compile_gs_arrays(system: PowerSystem) -> GsArrays:
    from .ac import ac_entry_host
    base = compile_ac_arrays(system)
    n = system.bus.number
    rows, cols, vals_host, diag_host = ac_entry_host(system)
    yg = vals_host.real
    yb = vals_host.imag

    counts = np.bincount(rows, minlength=n)
    dmax = int(counts.max())
    nb = np.zeros((n, dmax), dtype=np.int32)
    yre = np.zeros((n, dmax))
    yim = np.zeros((n, dmax))
    pos = np.zeros(n, dtype=np.int64)
    for k in range(len(rows)):
        i = rows[k]
        nb[i, pos[i]] = cols[k]
        yre[i, pos[i]] = yg[k]
        yim[i, pos[i]] = yb[k]
        pos[i] += 1

    dre = yg[diag_host]
    dim = yb[diag_host]

    vg = np.ones(n)
    for i, gens in system.bus.supply.generator.items():
        if gens and system.bus.layout.type[i] != 1:
            vg[i] = system.generator.voltage.magnitude[gens[0]]

    return GsArrays(
        nb=jnp.asarray(nb), yre=jnp.asarray(yre), yim=jnp.asarray(yim),
        dre=jnp.asarray(dre), dim=jnp.asarray(dim),
        bus_type=base.bus_type, slack=base.slack,
        p_sched=base.p_sched, q_sched=base.q_sched, vg=jnp.asarray(vg),
    )


def _cdiv(ar, ai, br, bi):
    d = br * br + bi * bi
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def _row_current(arr: GsArrays, i, vre, vim):
    """I_i = sum_j Y_ij V_j over the padded neighbor row."""
    nb = arr.nb[i]
    yr = arr.yre[i]
    yi = arr.yim[i]
    vr = vre[nb]
    vi = vim[nb]
    ire = jnp.sum(yr * vr - yi * vi)
    iim = jnp.sum(yr * vi + yi * vr)
    return ire, iim


def _gs_sweep(arr: GsArrays, vre, vim):
    """One Gauss-Seidel iteration (reference solve!, acPowerFlow.jl:985-1041)."""
    n = vre.shape[0]

    def pq_body(i, carry):
        vre, vim = carry

        def upd(vre, vim):
            # I = S*/conj(V) - sum Y V ;  V += I / Y_ii
            sre = arr.p_sched[i]
            sim = -arr.q_sched[i]
            cr, ci = _cdiv(sre, sim, vre[i], -vim[i])
            ire, iim = _row_current(arr, i, vre, vim)
            num_r, num_i = cr - ire, ci - iim
            dr, di = _cdiv(num_r, num_i, arr.dre[i], arr.dim[i])
            return vre.at[i].add(dr), vim.at[i].add(di)

        is_pq = arr.bus_type[i] == 1
        vre, vim = jax.lax.cond(is_pq, upd, lambda a, b: (a, b), vre, vim)
        return vre, vim

    vre, vim = jax.lax.fori_loop(0, n, pq_body, (vre, vim))

    def pv_body(i, carry):
        vre, vim = carry

        def upd(vre, vim):
            ire, iim = _row_current(arr, i, vre, vim)
            # Q = Im(conj(V) I)
            q = vre[i] * iim - vim[i] * ire
            inj_r, inj_i = arr.p_sched[i], q
            cr, ci = _cdiv(inj_r, inj_i, vre[i], -vim[i])
            dr, di = _cdiv(cr - ire, ci - iim, arr.dre[i], arr.dim[i])
            return vre.at[i].add(dr), vim.at[i].add(di)

        is_pv = arr.bus_type[i] == 2
        vre, vim = jax.lax.cond(is_pv, upd, lambda a, b: (a, b), vre, vim)
        return vre, vim

    vre, vim = jax.lax.fori_loop(0, n, pv_body, (vre, vim))

    # PV magnitude re-projection to the generator setpoint
    mag = jnp.sqrt(vre**2 + vim**2)
    is_pv = arr.bus_type == 2
    scale = jnp.where(is_pv, arr.vg / mag, 1.0)
    return vre * scale, vim * scale


def _gs_mismatch(arr: GsArrays, vre, vim):
    """Reference mismatch! for Gauss-Seidel (acPowerFlow.jl:732-764)."""
    n = vre.shape[0]
    i = jnp.arange(n)
    # S_i = V_i conj(sum Y V) via the padded table, vectorized
    vr = vre[arr.nb]
    vi = vim[arr.nb]
    ire = jnp.sum(arr.yre * vr - arr.yim * vi, axis=1)
    iim = jnp.sum(arr.yre * vi + arr.yim * vr, axis=1)
    p = vre * ire + vim * iim
    q = vim * ire - vre * iim
    is_pq = arr.bus_type == 1
    is_pv = arr.bus_type == 2
    mp = jnp.where(is_pq | is_pv, p - arr.p_sched, 0.0)
    mq = jnp.where(is_pq, q - arr.q_sched, 0.0)
    return jnp.max(jnp.abs(mp)), jnp.max(jnp.abs(mq))


_gs_mismatch_jit = jax.jit(_gs_mismatch)
_gs_sweep_jit = jax.jit(_gs_sweep)


@partial(jax.jit, static_argnames="max_iter")
def _gs_solve(arr: GsArrays, vm, va, tol: float, max_iter: int):
    vre = vm * jnp.cos(va)
    vim = vm * jnp.sin(va)
    del_p, del_q = _gs_mismatch(arr, vre, vim)

    def cond(carry):
        vre, vim, it, del_p, del_q = carry
        return (~((del_p < tol) & (del_q < tol))) & (it < max_iter)

    def body(carry):
        vre, vim, it, _, _ = carry
        vre, vim = _gs_sweep(arr, vre, vim)
        del_p, del_q = _gs_mismatch(arr, vre, vim)
        return vre, vim, it + 1, del_p, del_q

    vre, vim, it, del_p, del_q = jax.lax.while_loop(
        cond, body, (vre, vim, jnp.int64(0), del_p, del_q))
    converged = (del_p < tol) & (del_q < tol)
    return (jnp.sqrt(vre**2 + vim**2), jnp.arctan2(vim, vre),
            it, del_p, del_q, converged)


def gauss_seidel(system: PowerSystem,
                 factorization: str = linalg.LU) -> AcPowerFlow:
    """Reference gaussSeidel (acPowerFlow.jl:563-619)."""
    system.check_slack()
    model(system, "ac")
    magnitude, angle = initialize_ac_power_flow(system)
    arrays = compile_gs_arrays(system)
    rev = system.model.revision
    return AcPowerFlow(
        system=system,
        voltage=Polar(magnitude, angle),
        method=MethodState("gauss_seidel", factorization),
        arrays=arrays,
        signature={"ac_model": rev.ac_model, "ac_pattern": rev.ac_pattern,
                   "type": rev.type, "injection": rev.injection,
                   "slack": rev.slack},
    )


def gs_mismatch(analysis: AcPowerFlow):
    vm = jnp.asarray(analysis.voltage.magnitude)
    va = jnp.asarray(analysis.voltage.angle)
    vre = vm * jnp.cos(va)
    vim = vm * jnp.sin(va)
    del_p, del_q = _gs_mismatch_jit(analysis.arrays, vre, vim)
    analysis.method.max_mismatch_active = float(del_p)
    analysis.method.max_mismatch_reactive = float(del_q)
    return float(del_p), float(del_q)


def gs_solve_step(analysis: AcPowerFlow):
    vm = jnp.asarray(analysis.voltage.magnitude)
    va = jnp.asarray(analysis.voltage.angle)
    vre = vm * jnp.cos(va)
    vim = vm * jnp.sin(va)
    vre, vim = _gs_sweep_jit(analysis.arrays, vre, vim)
    analysis.voltage.magnitude = np.asarray(jnp.sqrt(vre**2 + vim**2))
    analysis.voltage.angle = np.asarray(jnp.arctan2(vim, vre))
    analysis.method.iteration += 1
