"""AC state estimation: Gauss-Newton WLS over a measurement-row IR.

Redesign of /root/reference/src/stateEstimation/
acStateEstimation.jl. The reference builds a sparse stacked Jacobian with a
giant per-row type switch re-filled each iteration (:261-583) and forms
gain = HᵀWH with SpGEMM + KLU (:878-904). Here the 21 typed measurement
rows (:131-236) are grouped by type into static index arrays; each group
evaluates vectorized closed-form h(x) and derivative 4-tuples
(ops/equations.py) scattered into a dense H (rows x 2n states). The gain
matrix is one dense matmul, the solve is mixed-precision LU (Normal) or QR of
W^1/2 H (Orthogonal, reference :906-931), and the whole Gauss-Newton loop
is a single ``lax.while_loop`` program. ``vmap`` over measurement means
gives batched Monte-Carlo estimation with the H-pattern shared.

PMU semantics are preserved exactly: polar vs rectangular rows, squared
magnitudes (varianceSquare), rectangular error propagation
(equations.jl:576-588), and correlated 2x2 precision blocks applied as
paired row corrections to W H and W r.

Iteration semantics match stateEstimation! (:1286-1329): the increment is
computed, convergence is judged on max|dx| before applying, and the count
equals the number of applied increments.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np

from ..ops import equations as eq
from ..ops import linalg
from ..system.model import model
from ..system.types import PowerSystem
from ..powerflow.ac import AcArrays, Polar, compile_ac_arrays
from ..utils.errors import MethodError_

# Branch-row group evaluation order (static): (type_code, coeff_fn, eval_fn)
BRANCH_GROUPS = (
    (2, eq.iij_coeff, eq.eval_iij),
    (3, eq.iji_coeff, eq.eval_iji),
    (4, eq.iij_coeff, eq.eval_iij2),
    (5, eq.iji_coeff, eq.eval_iji2),
    (7, eq.pij_coeff, eq.eval_pij),
    (8, eq.pji_coeff, eq.eval_pji),
    (10, eq.qij_coeff, eq.eval_qij),
    (11, eq.qji_coeff, eq.eval_qji),
    (14, eq.psi_ij_coeff, eq.eval_psi_ij),
    (15, eq.psi_ji_coeff, eq.eval_psi_ji),
    (18, eq.psi_ij_coeff, eq.eval_re_iij),
    (19, eq.psi_ji_coeff, eq.eval_re_iji),
    (20, eq.psi_ij_coeff, eq.eval_im_iij),
    (21, eq.psi_ji_coeff, eq.eval_im_iji),
)


class BranchGroup(NamedTuple):
    rows: jax.Array   # i32[k] measurement row ids
    f: jax.Array      # i32[k] from-bus
    t: jax.Array      # i32[k] to-bus
    a: jax.Array      # f64[k] PiModel coefficients
    b: jax.Array
    c: jax.Array
    d: jax.Array
    phi: jax.Array    # f64[k] transformer shift angle


class SeArrays(NamedTuple):
    mean: jax.Array        # f64[m] (status-masked)
    w: jax.Array           # f64[m] diagonal precision
    status: jax.Array      # f64[m] 0/1 row mask
    pair_r1: jax.Array     # i32[p] correlated PMU row pairs
    pair_r2: jax.Array
    pair_off: jax.Array    # f64[p] off-diagonal precision
    slack: jax.Array       # i32
    # voltage-magnitude rows (types 1, 12)
    vm_rows: jax.Array
    vm_bus: jax.Array
    # voltage-angle rows (type 13)
    va_rows: jax.Array
    va_bus: jax.Array
    # rectangular bus phasor rows (types 16, 17)
    rev_rows: jax.Array
    rev_bus: jax.Array
    imv_rows: jax.Array
    imv_bus: jax.Array
    # branch groups, in BRANCH_GROUPS order
    branch: tuple
    # injection rows (types 6, 9): per-measurement and flattened Y entries
    p_rows: jax.Array      # i32[mp]
    p_bus: jax.Array
    p_ent_meas: jax.Array  # i32[E] scatter: measurement row per Y entry
    p_ent_k: jax.Array     # i32[E] Y entry index
    q_rows: jax.Array
    q_bus: jax.Array
    q_ent_meas: jax.Array
    q_ent_k: jax.Array


@dataclass
class SeMethod:
    name: str
    factorization: str = linalg.LU
    iteration: int = 0
    converged: bool = False
    max_increment: float = np.inf
    objective: float = 0.0
    residual: Optional[np.ndarray] = None
    jacobian: Optional[np.ndarray] = None
    precision_diag: Optional[np.ndarray] = None
    mean: Optional[np.ndarray] = None
    type: Optional[np.ndarray] = None
    row_device: Optional[list] = None


@dataclass
class AcStateEstimation:
    system: PowerSystem
    monitoring: object
    voltage: Polar
    method: SeMethod
    arrays: SeArrays
    net: AcArrays
    power: Optional[object] = None
    current: Optional[object] = None
    kind: str = "state_estimation"
    signature: dict = field(default_factory=dict)

    def _refresh_arrays(self):
        rev = self.system.model.revision
        mrev = self.monitoring.revision
        sig = self.signature
        if sig and sig.get("slack") != rev.slack:
            # angle datum moved with the slack: shift the live state's
            # angles uniformly so the new slack sits at the system's stored
            # angle — the datum a fresh build pins (see AcPowerFlow.
            # _refresh_arrays; flows/residuals are datum-invariant)
            bus = self.system.bus
            slack = bus.layout.slack
            va = np.asarray(self.voltage.angle, dtype=float).copy()
            va = va + (float(bus.voltage.angle[slack]) - va[slack])
            self.voltage.angle = va
        if (sig.get("ac_model") != rev.ac_model
                or sig.get("measurement") != mrev.measurement
                or sig.get("slack") != rev.slack):
            (self.arrays, self.method.type,
             self.method.row_device) = compile_se_arrays(
                self.system, self.monitoring)
            self.net = compile_ac_arrays(self.system)
            sig.update(ac_model=rev.ac_model, measurement=mrev.measurement,
                       meas_values=mrev.values, slack=rev.slack)
        elif sig.get("meas_values") != mrev.values:
            # numeric-only edit (update_*meter means/variances/statuses,
            # bad-data deactivation): patch the per-row value vectors in
            # place — the reference's live row patches (powermeter.jl:
            # 629-958, pmu.jl:566-915). The device-resident entry patterns
            # (the expensive upload at ACTIVSg scale) stay untouched.
            mean, w, status, pair_off = compile_se_arrays(
                self.system, self.monitoring, values_only=True)
            self.arrays = self.arrays._replace(
                mean=jnp.asarray(mean), w=jnp.asarray(w),
                status=jnp.asarray(status),
                pair_off=jnp.asarray(pair_off))
            sig["meas_values"] = mrev.values


def compile_se_arrays(system: PowerSystem, monitoring,
                      return_host: bool = False, values_only: bool = False):
    """Build the measurement-row IR (reference acWLS, :77-259): rows in
    device order — voltmeters, ammeters, wattmeters, varmeters, PMUs (PMUs
    contribute two rows each).

    ``values_only=True`` runs just the device walk and returns the
    ``(mean, w, status, pair_off)`` host vectors — the live row-value
    patch used by ``_refresh_arrays`` when only means/variances/statuses
    changed (the index patterns and branch coefficients are still valid)."""
    model(system, "ac")
    n = system.bus.number
    volt, amp = monitoring.voltmeter, monitoring.ammeter
    watt, var, pmu = monitoring.wattmeter, monitoring.varmeter, monitoring.pmu

    if not values_only:
        coo = system.model.ac.nodal.tocoo()
        order = np.lexsort((coo.col, coo.row))
        yrows = coo.row[order]

    mean, w, status, types = [], [], [], []
    row_device = []  # (device kind, device index) per measurement row
    vm_rows, vm_bus, va_rows, va_bus = [], [], [], []
    rev_rows, rev_bus, imv_rows, imv_bus = [], [], [], []
    br_groups = {t: ([], []) for t, _, _ in BRANCH_GROUPS}  # rows, branch
    p_rows, p_bus, q_rows, q_bus = [], [], [], []
    pair_r1, pair_r2, pair_off = [], [], []

    row = 0

    def push(m_, v_, st_, ty_):
        nonlocal row
        mean.append(st_ * m_)
        w.append(1.0 / v_)
        status.append(float(st_))
        types.append(ty_)
        row += 1

    for i in range(volt.number):
        k = int(volt.layout.index[i])
        st = int(volt.magnitude.status[i])
        vm_rows.append(row)
        vm_bus.append(k)
        row_device.append(("voltmeter", i))
        push(volt.magnitude.mean[i], volt.magnitude.variance[i], st, 1)

    for i in range(amp.number):
        k = int(amp.layout.index[i])
        st = int(amp.magnitude.status[i])
        sq = bool(amp.layout.square[i])
        is_from = bool(amp.layout.from_[i])
        ty = (4 if is_from else 5) if sq else (2 if is_from else 3)
        br_groups[ty][0].append(row)
        br_groups[ty][1].append(k)
        row_device.append(("ammeter", i))
        m_val = amp.magnitude.mean[i] ** (2 if sq else 1)
        v_val = amp.magnitude.variance[i]
        if sq:
            v_val = 4 * amp.magnitude.mean[i] ** 2 * v_val
        push(m_val, v_val, st, ty)

    for i in range(watt.number):
        k = int(watt.layout.index[i])
        st = int(watt.active.status[i])
        row_device.append(("wattmeter", i))
        if watt.layout.bus[i]:
            p_rows.append(row)
            p_bus.append(k)
            push(watt.active.mean[i], watt.active.variance[i], st, 6)
        else:
            ty = 7 if watt.layout.from_[i] else 8
            br_groups[ty][0].append(row)
            br_groups[ty][1].append(k)
            push(watt.active.mean[i], watt.active.variance[i], st, ty)

    for i in range(var.number):
        k = int(var.layout.index[i])
        st = int(var.reactive.status[i])
        row_device.append(("varmeter", i))
        if var.layout.bus[i]:
            q_rows.append(row)
            q_bus.append(k)
            push(var.reactive.mean[i], var.reactive.variance[i], st, 9)
        else:
            ty = 10 if var.layout.from_[i] else 11
            br_groups[ty][0].append(row)
            br_groups[ty][1].append(k)
            push(var.reactive.mean[i], var.reactive.variance[i], st, ty)

    for i in range(pmu.number):
        row_device.append(("pmu", i))
        row_device.append(("pmu", i))
        k = int(pmu.layout.index[i])
        st_m = int(pmu.magnitude.status[i])
        st_a = int(pmu.angle.status[i])
        if pmu.layout.polar[i]:
            sq = bool(pmu.layout.square[i])
            if pmu.layout.bus[i]:
                vm_rows.append(row)
                vm_bus.append(k)
                push(pmu.magnitude.mean[i], pmu.magnitude.variance[i],
                     st_m, 12)
                va_rows.append(row)
                va_bus.append(k)
                push(pmu.angle.mean[i], pmu.angle.variance[i], st_a, 13)
            else:
                is_from = bool(pmu.layout.from_[i])
                ty = (4 if is_from else 5) if sq else (2 if is_from else 3)
                br_groups[ty][0].append(row)
                br_groups[ty][1].append(k)
                m_val = pmu.magnitude.mean[i] ** (2 if sq else 1)
                v_val = pmu.magnitude.variance[i]
                if sq:
                    v_val = 4 * pmu.magnitude.mean[i] ** 2 * v_val
                push(m_val, v_val, st_m, ty)
                ty_a = 14 if is_from else 15
                br_groups[ty_a][0].append(row)
                br_groups[ty_a][1].append(k)
                push(pmu.angle.mean[i], pmu.angle.variance[i], st_a, ty_a)
        else:
            st = st_m * st_a
            mag, ang = pmu.magnitude.mean[i], pmu.angle.mean[i]
            cos_t, sin_t = np.cos(ang), np.sin(ang)
            var_re, var_im = eq.variance_pmu(
                pmu.magnitude.variance[i], pmu.angle.variance[i],
                mag, cos_t, sin_t)
            if pmu.layout.correlated[i]:
                w11, w22, off = eq.covariance_pmu(
                    pmu.magnitude.variance[i], pmu.angle.variance[i],
                    mag, cos_t, sin_t, var_re, var_im)
                pair_r1.append(row)
                pair_r2.append(row + 1)
                pair_off.append(off)
                weights = (w11, w22)
            else:
                weights = (1.0 / var_re, 1.0 / var_im)
            if pmu.layout.bus[i]:
                rev_rows.append(row)
                rev_bus.append(k)
                mean.append(st * mag * cos_t)
                w.append(weights[0])
                status.append(float(st))
                types.append(16)
                row += 1
                imv_rows.append(row)
                imv_bus.append(k)
                mean.append(st * mag * sin_t)
                w.append(weights[1])
                status.append(float(st))
                types.append(17)
                row += 1
            else:
                is_from = bool(pmu.layout.from_[i])
                ty_re = 18 if is_from else 19
                ty_im = 20 if is_from else 21
                br_groups[ty_re][0].append(row)
                br_groups[ty_re][1].append(k)
                mean.append(st * mag * cos_t)
                w.append(weights[0])
                status.append(float(st))
                types.append(ty_re)
                row += 1
                br_groups[ty_im][0].append(row)
                br_groups[ty_im][1].append(k)
                mean.append(st * mag * sin_t)
                w.append(weights[1])
                status.append(float(st))
                types.append(ty_im)
                row += 1

    if values_only:
        return (np.asarray(mean), np.asarray(w), np.asarray(status),
                np.asarray(pair_off))

    # ---- device arrays ---------------------------------------------------
    f_all = system.branch.layout.from_bus.array[: system.branch.number]
    t_all = system.branch.layout.to_bus.array[: system.branch.number]

    groups = []
    for ty, coeff_fn, _ in BRANCH_GROUPS:
        rows_, brs_ = br_groups[ty]
        brs_np = np.asarray(brs_, dtype=np.int64)
        co = coeff_fn(system, brs_np) if len(brs_) else eq.PiCoeff(
            *(np.empty(0),) * 4)
        phi_all = system.branch.parameter.shift_angle.array[
            : system.branch.number]
        groups.append(BranchGroup(
            rows=np.asarray(rows_, dtype=np.int32),
            f=f_all[brs_np].astype(np.int32),
            t=t_all[brs_np].astype(np.int32),
            a=np.asarray(co.a), b=np.asarray(co.b),
            c=np.asarray(co.c), d=np.asarray(co.d),
            phi=np.asarray(phi_all[brs_np])))

    # bus -> Y-entry index ranges, precomputed once: the previous per-row
    # flatnonzero scan was O(rows * nnz) — the dominant cost of every SE
    # snapshot rebuild at ACTIVSg scale (~4 s of the 4.1 s 10k build)
    y_order = np.argsort(yrows, kind="stable")
    y_starts = np.searchsorted(yrows[y_order], np.arange(n + 1))

    def _inj_entries(rows_list, bus_list):
        ent_meas, ent_k = [], []
        for r_, b_ in zip(rows_list, bus_list):
            ks = y_order[y_starts[b_]:y_starts[b_ + 1]]
            ent_meas.extend([r_] * len(ks))
            ent_k.extend(ks.tolist())
        return (np.asarray(ent_meas, dtype=np.int32),
                np.asarray(ent_k, dtype=np.int32))

    p_ent_meas, p_ent_k = _inj_entries(p_rows, p_bus)
    q_ent_meas, q_ent_k = _inj_entries(q_rows, q_bus)

    # host mirror first, device pytree second: compile/routing consumers
    # (the BBD builders, bench scenario generators) read the host mirror
    arr_host = SeArrays(
        mean=np.asarray(mean, dtype=np.float64),
        w=np.asarray(w, dtype=np.float64),
        status=np.asarray(status, dtype=np.float64),
        pair_r1=np.asarray(pair_r1, dtype=np.int32),
        pair_r2=np.asarray(pair_r2, dtype=np.int32),
        pair_off=np.asarray(pair_off, dtype=np.float64),
        slack=np.int32(system.bus.layout.slack),
        vm_rows=np.asarray(vm_rows, dtype=np.int32),
        vm_bus=np.asarray(vm_bus, dtype=np.int32),
        va_rows=np.asarray(va_rows, dtype=np.int32),
        va_bus=np.asarray(va_bus, dtype=np.int32),
        rev_rows=np.asarray(rev_rows, dtype=np.int32),
        rev_bus=np.asarray(rev_bus, dtype=np.int32),
        imv_rows=np.asarray(imv_rows, dtype=np.int32),
        imv_bus=np.asarray(imv_bus, dtype=np.int32),
        branch=tuple(groups),
        p_rows=np.asarray(p_rows, dtype=np.int32),
        p_bus=np.asarray(p_bus, dtype=np.int32),
        p_ent_meas=p_ent_meas, p_ent_k=p_ent_k,
        q_rows=np.asarray(q_rows, dtype=np.int32),
        q_bus=np.asarray(q_bus, dtype=np.int32),
        q_ent_meas=q_ent_meas, q_ent_k=q_ent_k,
    )
    import jax
    arr = jax.tree.map(jnp.asarray, arr_host)
    if return_host:
        return arr, np.asarray(types, dtype=np.int8), row_device, arr_host
    return arr, np.asarray(types, dtype=np.int8), row_device


# --------------------------------------------------------------------------
# Jacobian/residual evaluation (pure)
# --------------------------------------------------------------------------

def h_entry_pattern(arr: SeArrays, net: AcArrays, n: int, xp=np):
    """(rows, cols) of every H entry, in the exact order ``h_entries``
    emits values. Cols index the 2n state vector (θ then V). Call with
    ``xp=np`` at compile time (the routing key for the BBD gain path) or
    ``xp=jnp`` under trace (the dense scatter pattern)."""
    a = xp.asarray
    rows, cols = [], []

    def add(r, c):
        rows.append(a(r).astype(xp.int64))
        cols.append(a(c).astype(xp.int64))

    add(arr.vm_rows, n + a(arr.vm_bus))
    add(arr.va_rows, a(arr.va_bus))
    add(arr.rev_rows, a(arr.rev_bus))
    add(arr.rev_rows, n + a(arr.rev_bus))
    add(arr.imv_rows, a(arr.imv_bus))
    add(arr.imv_rows, n + a(arr.imv_bus))
    for grp in arr.branch:
        if grp.rows.shape[0] == 0:
            continue
        add(grp.rows, a(grp.f))
        add(grp.rows, a(grp.t))
        add(grp.rows, n + a(grp.f))
        add(grp.rows, n + a(grp.t))
    net_cols = a(net.cols)
    if arr.p_rows.shape[0]:
        ke = a(arr.p_ent_k)
        add(arr.p_ent_meas, net_cols[ke])
        add(arr.p_ent_meas, n + net_cols[ke])
        add(arr.p_rows, a(arr.p_bus))
        add(arr.p_rows, n + a(arr.p_bus))
    if arr.q_rows.shape[0]:
        ke = a(arr.q_ent_k)
        add(arr.q_ent_meas, net_cols[ke])
        add(arr.q_ent_meas, n + net_cols[ke])
        add(arr.q_rows, a(arr.q_bus))
        add(arr.q_rows, n + a(arr.q_bus))
    return xp.concatenate(rows), xp.concatenate(cols)


def h_entries(arr: SeArrays, net: AcArrays, vm, va):
    """Per-entry H values (pattern order = ``h_entry_pattern``) + h(x).

    The measurement Jacobian in entry-IR form: callers scatter the values
    into whatever blocked layout their solver needs (dense H, or the
    routed BBD gain blocks)."""
    n = vm.shape[0]
    h = jnp.zeros(arr.mean.shape[0], dtype=vm.dtype)
    vals = []

    one_vm = jnp.ones(arr.vm_rows.shape[0], dtype=vm.dtype)
    vals.append(one_vm)
    h = h.at[arr.vm_rows].add(vm[arr.vm_bus])
    one_va = jnp.ones(arr.va_rows.shape[0], dtype=vm.dtype)
    vals.append(one_va)
    h = h.at[arr.va_rows].add(va[arr.va_bus])

    cb = jnp.cos(va[arr.rev_bus])
    sb = jnp.sin(va[arr.rev_bus])
    vals.append(-vm[arr.rev_bus] * sb)
    vals.append(cb)
    h = h.at[arr.rev_rows].add(vm[arr.rev_bus] * cb)
    ci = jnp.cos(va[arr.imv_bus])
    si = jnp.sin(va[arr.imv_bus])
    vals.append(vm[arr.imv_bus] * ci)
    vals.append(si)
    h = h.at[arr.imv_rows].add(vm[arr.imv_bus] * si)

    # branch groups
    for (ty, _, eval_fn), grp in zip(BRANCH_GROUPS, arr.branch):
        if grp.rows.shape[0] == 0:
            continue
        vi, vj = vm[grp.f], vm[grp.t]
        ti, tj = va[grp.f], va[grp.t]
        # the reference evaluates branch rows at θij - φ (equations.jl:
        # ViVjθijState / ViVjθiθjState / VjViθjθiState): from-side rows
        # shift θj by +φ, to-side phasor rows shift θi by -φ.
        if ty in (15, 19, 21):
            ti = ti - grp.phi
        else:
            tj = tj + grp.phi
        co = eq.PiCoeff(grp.a, grp.b, grp.c, grp.d)
        hv, dti, dtj, dvi, dvj = eval_fn(co, vi, vj, ti, tj)
        h = h.at[grp.rows].add(hv)
        vals.extend([dti, dtj, dvi, dvj])

    # injections (6, 9)
    if arr.p_rows.shape[0] or arr.q_rows.shape[0]:
        vi_e = vm[net.rows]
        vj_e = vm[net.cols]
        th_e = va[net.rows] - va[net.cols]
        st_e, ct_e = jnp.sin(th_e), jnp.cos(th_e)
        vv = vi_e * vj_e
        t1 = vv * (net.yg * ct_e + net.yb * st_e)
        t2 = vv * (net.yg * st_e - net.yb * ct_e)
        p_bus_all = jax.ops.segment_sum(t1, net.rows, num_segments=n)
        q_bus_all = jax.ops.segment_sum(t2, net.rows, num_segments=n)
        off = (net.rows != net.cols).astype(vm.dtype)
        # dP/dθj, dP/dVj per entry (off-diagonal)
        dp_dtj = t2 * off
        dp_dvj = (vi_e * (net.yg * ct_e + net.yb * st_e)) * off
        dq_dtj = -t1 * off
        dq_dvj = (vi_e * (net.yg * st_e - net.yb * ct_e)) * off
        gii = net.yg[net.diag]
        bii = net.yb[net.diag]

        if arr.p_rows.shape[0]:
            h = h.at[arr.p_rows].add(p_bus_all[arr.p_bus])
            ke = arr.p_ent_k
            pb = arr.p_bus
            vals.append(dp_dtj[ke])
            vals.append(dp_dvj[ke])
            vals.append(-q_bus_all[pb] - bii[pb] * vm[pb] ** 2)
            vals.append(p_bus_all[pb] / vm[pb] + gii[pb] * vm[pb])
        if arr.q_rows.shape[0]:
            h = h.at[arr.q_rows].add(q_bus_all[arr.q_bus])
            ke = arr.q_ent_k
            qb = arr.q_bus
            vals.append(dq_dtj[ke])
            vals.append(dq_dvj[ke])
            vals.append(p_bus_all[qb] - gii[qb] * vm[qb] ** 2)
            vals.append(q_bus_all[qb] / vm[qb] - bii[qb] * vm[qb])

    return jnp.concatenate(vals), h * arr.status


def build_h(arr: SeArrays, net: AcArrays, vm, va):
    """Dense measurement Jacobian H (m x 2n) and model values h(x):
    one scatter-add of the entry-IR values."""
    n = vm.shape[0]
    m = arr.mean.shape[0]
    vals, h = h_entries(arr, net, vm, va)
    ent_rows, ent_cols = h_entry_pattern(arr, net, n, xp=jnp)
    H = jnp.zeros((m, 2 * n), dtype=vm.dtype)
    H = H.at[ent_rows, ent_cols].add(vals)
    H = H * arr.status[:, None]
    return H, h


def _weighted(arr: SeArrays, H, r):
    """Apply W (diagonal + correlated 2x2 blocks) to H and r."""
    WH = arr.w[:, None] * H
    wr = arr.w * r
    if arr.pair_r1.shape[0]:
        WH = WH.at[arr.pair_r1].add(arr.pair_off[:, None] * H[arr.pair_r2])
        WH = WH.at[arr.pair_r2].add(arr.pair_off[:, None] * H[arr.pair_r1])
        wr = wr.at[arr.pair_r1].add(arr.pair_off * r[arr.pair_r2])
        wr = wr.at[arr.pair_r2].add(arr.pair_off * r[arr.pair_r1])
    return WH, wr


def _w_apply_vec(arr: SeArrays, v):
    """Apply W (diagonal + correlated 2x2 blocks) to a residual vector."""
    wv = arr.w * v
    if arr.pair_r1.shape[0]:
        wv = wv.at[arr.pair_r1].add(arr.pair_off * v[arr.pair_r2])
        wv = wv.at[arr.pair_r2].add(arr.pair_off * v[arr.pair_r1])
    return wv


def gn_increment(arr: SeArrays, net: AcArrays, vm, va, kind: str):
    """One Gauss-Newton increment (reference increment!, :878-931).

    Normal-equations path: the gain H'WH is formed AND factorized in f32,
    with ``Precision.HIGHEST`` on every gain matmul — a reduced-precision
    f32 product (bf16 passes, or TF32 on a GPU) cannot carry measurement
    weights spanning 1e4..1e8: the refinement gate then stays tripped at
    pegase scale and no lane converges. The dense f64 H is never
    materialized on this path: the Jacobian lives as its O(nnz) entry
    list, the f32 scatter feeds the gain, and the f64 refinement
    residuals ride sparse segment-sum matvecs — at pegase scale this cuts
    the per-scenario device-memory footprint ~4x (the chunk-size lever of
    the batched Monte-Carlo SE) and removes every O(m·n) f64 matmul from
    the iteration."""
    n = vm.shape[0]

    if kind in (linalg.QR, linalg.PW):
        H, h = build_h(arr, net, vm, va)
        r = arr.mean - h
        col_mask = jnp.ones(2 * n, dtype=vm.dtype).at[arr.slack].set(0.0)
        Hm = H * col_mask[None, :]
        # square-root methods on W^1/2 H (diagonal weights only):
        # Orthogonal (QR) or Peters-Wilkinson (tall LU + L-normal eqs)
        sw = jnp.sqrt(arr.w)[:, None]
        A = sw * Hm
        # append identity row for the slack column to keep A full rank
        e = jnp.zeros((1, 2 * n), dtype=vm.dtype).at[0, arr.slack].set(1.0)
        A = jnp.concatenate([A, e], axis=0)
        b = jnp.concatenate([jnp.sqrt(arr.w) * r, jnp.zeros(1)])
        if kind == linalg.PW:
            dx = linalg.pw_lsq_solve(A, b)
        else:
            dx = linalg.solve(linalg.factorize(A, linalg.QR), b)
        rel = jnp.asarray(0.0, dtype=vm.dtype)  # square-root path: no gate
        dx = dx * jnp.ones(2 * n).at[arr.slack].set(0.0)
        return dx, jnp.max(jnp.abs(dx)), rel

    m = arr.mean.shape[0]
    vals, h = h_entries(arr, net, vm, va)
    ent_rows, ent_cols = h_entry_pattern(arr, net, n, xp=jnp)
    col_mask = jnp.ones(2 * n, dtype=vm.dtype).at[arr.slack].set(0.0)
    # status rows + slack column masks applied in ENTRY space — identical
    # to masking the scattered dense H (build_h) row/column-wise
    vals = vals * arr.status[ent_rows] * col_mask[ent_cols]
    r = arr.mean - h

    def hmat(xv):          # H @ xv, f64, O(nnz)
        return jax.ops.segment_sum(vals * xv[ent_cols], ent_rows,
                                   num_segments=m)

    def hmat_t(v):         # Hᵀ @ v, f64, O(nnz)
        return jax.ops.segment_sum(vals * v[ent_rows], ent_cols,
                                   num_segments=2 * n)

    wr = _w_apply_vec(arr, r)
    rhs = hmat_t(wr)
    reg = 1.0 - col_mask                 # slack-column identity

    hi = jax.lax.Precision.HIGHEST
    h32 = jnp.zeros((m, 2 * n), dtype=jnp.float32).at[
        ent_rows, ent_cols].add(vals.astype(jnp.float32))
    hw32 = jnp.sqrt(arr.w).astype(jnp.float32)[:, None] * h32
    g32 = jnp.matmul(hw32.T, hw32, precision=hi)
    if arr.pair_r1.shape[0]:
        # correlated PMU 2x2 blocks: W = D + P with P carrying the pair
        # off-diagonals; HᵀPH is a thin outer-product correction
        po32 = arr.pair_off.astype(jnp.float32)
        h1 = h32[arr.pair_r1] * po32[:, None]
        h2 = h32[arr.pair_r2]
        g32 = g32 + jnp.matmul(h1.T, h2, precision=hi) \
            + jnp.matmul(h2.T, h1, precision=hi)
    g32 = g32 + jnp.diag(reg.astype(jnp.float32))
    lu, piv = jsl.lu_factor(g32)

    def op(xv):
        return hmat_t(_w_apply_vec(arr, hmat(xv))) + reg * xv

    dx = jsl.lu_solve((lu, piv),
                      rhs.astype(jnp.float32)).astype(rhs.dtype)

    # residual-gated refinement: sweep (two O(nnz) f64 sparse matvecs
    # each) until the operator residual of the normal equations is tiny
    # or the sweep cap is hit. Well-conditioned gains exit after the same
    # 2 sweeps as the old fixed count (zero-noise reproduction stays
    # ≤1e-10, tests/test_estimation.py); an ill-conditioned gain
    # (cond ≳ 1e7, where the f32 factor stops contracting) keeps the
    # residual high, the loop stops making progress, and the returned
    # ``rel`` lets the driver escalate to the QR path instead of
    # silently degrading the increment.
    rhs_norm = jnp.linalg.norm(rhs) + 1e-300

    def sweep_cond(c):
        _, rel, prev, k = c
        return (rel > 1e-13) & (rel < 0.5 * prev) & (k < 8)

    def sweep(c):
        xv, rel, _, k = c
        res = rhs - op(xv)
        d = jsl.lu_solve((lu, piv), res.astype(jnp.float32))
        return (xv + d.astype(rhs.dtype),
                jnp.linalg.norm(res) / rhs_norm, rel, k + 1)

    # always take the first sweep (matches the old fixed-2 minimum)
    dx, rel, _, _ = sweep((dx, jnp.inf, jnp.inf, 0))
    dx, rel, _, _ = jax.lax.while_loop(
        sweep_cond, sweep, (dx, rel, jnp.inf, 1))
    dx = dx * col_mask
    return dx, jnp.max(jnp.abs(dx)), rel


@partial(jax.jit, static_argnames=("kind", "max_iter"))
def _se_solve(arr: SeArrays, net: AcArrays, vm, va, tol: float,
              max_iter: int, kind: str):
    dx, maxinc, rel = gn_increment(arr, net, vm, va, kind)
    n = vm.shape[0]

    def cond(carry):
        vm, va, dx, maxinc, relmax, it = carry
        return (maxinc >= tol) & (it < max_iter)

    def body(carry):
        vm, va, dx, _, relmax, it = carry
        va = va + dx[:n]
        vm = vm + dx[n:]
        dx, maxinc, rel = gn_increment(arr, net, vm, va, kind)
        return vm, va, dx, maxinc, jnp.maximum(relmax, rel), it + 1

    vm, va, dx, maxinc, relmax, it = jax.lax.while_loop(
        cond, body, (vm, va, dx, maxinc, rel, jnp.int64(0)))
    return vm, va, it, maxinc, maxinc < tol, relmax


def _wls_objective(arr: SeArrays, net: AcArrays, vm, va):
    """J(x) = r' W r (incl. correlated PMU cross terms)."""
    _, h = build_h(arr, net, vm, va)
    r = arr.mean - h
    val = jnp.sum(arr.w * r * r)
    if arr.pair_r1.shape[0]:
        val = val + jnp.sum(2.0 * arr.pair_off * r[arr.pair_r1]
                            * r[arr.pair_r2])
    return val


@partial(jax.jit, static_argnames=("kind", "max_iter"))
def _se_solve_damped(arr: SeArrays, net: AcArrays, vm, va, tol: float,
                     max_iter: int, kind: str):
    """Gauss-Newton with backtracking on the WLS objective — robust for
    low-redundancy / polar-phasor sets from flat starts (the reference's
    plain iteration can diverge there)."""
    dx, maxinc, rel = gn_increment(arr, net, vm, va, kind)
    n = vm.shape[0]

    def cond(carry):
        vm, va, dx, maxinc, relmax, it = carry
        return (maxinc >= tol) & (it < max_iter)

    def body(carry):
        vm, va, dx, _, relmax, it = carry
        j0 = _wls_objective(arr, net, vm, va)

        def bt_cond(c):
            alpha, j_new = c
            return (j_new > j0) & (alpha > 0.03)

        def bt_body(c):
            alpha, _ = c
            alpha = alpha * 0.5
            j_new = _wls_objective(arr, net, vm + alpha * dx[n:],
                                   va + alpha * dx[:n])
            return alpha, j_new

        j1 = _wls_objective(arr, net, vm + dx[n:], va + dx[:n])
        alpha, _ = jax.lax.while_loop(bt_cond, bt_body, (1.0, j1))
        va = va + alpha * dx[:n]
        vm = vm + alpha * dx[n:]
        dx, maxinc, rel = gn_increment(arr, net, vm, va, kind)
        return vm, va, dx, maxinc, jnp.maximum(relmax, rel), it + 1

    vm, va, dx, maxinc, relmax, it = jax.lax.while_loop(
        cond, body, (vm, va, dx, maxinc, rel, jnp.int64(0)))
    return vm, va, it, maxinc, maxinc < tol, relmax


_gn_increment_jit = jax.jit(gn_increment, static_argnames="kind")
_build_h_jit = jax.jit(build_h)


# --------------------------------------------------------------------------
# API
# --------------------------------------------------------------------------

def gauss_newton(monitoring, factorization: str = linalg.LU
                 ) -> AcStateEstimation:
    """Reference gaussNewton (acStateEstimation.jl:43-75)."""
    system = monitoring.system
    system.check_slack()
    model(system, "ac")
    n = system.bus.number
    if factorization in (linalg.QR, linalg.PW):
        pmu = monitoring.pmu
        npmu = pmu.number
        corr = pmu.layout.correlated.array[:npmu].astype(bool)
        polar = pmu.layout.polar.array[:npmu].astype(bool)
        if np.any(corr & ~polar):
            # reference acStateEstimation.jl:47-49: the 2x2 off-diagonal
            # precision blocks cannot ride the W^1/2 H orthogonal path
            raise MethodError_(
                "A non-diagonal precision matrix prevents the use of the "
                "select method.")
    arr, types, row_device = compile_se_arrays(system, monitoring)
    net = compile_ac_arrays(system)
    rev = system.model.revision
    method = SeMethod("gauss_newton", factorization)
    method.type = types
    method.row_device = row_device
    return AcStateEstimation(
        system=system,
        monitoring=monitoring,
        voltage=Polar(system.bus.voltage.magnitude.array[:n].copy(),
                      system.bus.voltage.angle.array[:n].copy()),
        method=method,
        arrays=arr,
        net=net,
        signature={"ac_model": rev.ac_model,
                   "measurement": monitoring.revision.measurement,
                   "meas_values": monitoring.revision.values,
                   "slack": rev.slack},
    )


def increment(analysis: AcStateEstimation) -> float:
    """Reference increment!: compute (but do not apply) the GN step."""
    analysis._refresh_arrays()
    vm = jnp.asarray(analysis.voltage.magnitude)
    va = jnp.asarray(analysis.voltage.angle)
    kind = analysis.method.factorization \
        if analysis.method.factorization in (linalg.QR, linalg.PW) \
        else linalg.LU
    dx, maxinc, rel = _gn_increment_jit(analysis.arrays, analysis.net,
                                        vm, va, kind)
    analysis.method._pending_dx = np.asarray(dx)
    analysis.method.max_increment = float(maxinc)
    analysis.method.refine_residual = float(rel)
    return float(maxinc)


def solve(analysis: AcStateEstimation):
    """Reference solve!: apply the pending increment."""
    dx = getattr(analysis.method, "_pending_dx", None)
    if dx is None:
        increment(analysis)
        dx = analysis.method._pending_dx
    n = analysis.system.bus.number
    analysis.voltage.angle = analysis.voltage.angle + dx[:n]
    analysis.voltage.magnitude = analysis.voltage.magnitude + dx[n:]
    analysis.method.iteration += 1
    analysis.method._pending_dx = None


def state_estimation(analysis, iteration: int = 40, tolerance: float = 1e-8,
                     power: bool = False, current: bool = False,
                     damping: bool = False, verbose: int | None = None):
    """Reference stateEstimation! driver. Dispatches on analysis type."""
    from .dcse import DcStateEstimation, dc_se_solve
    from .pmuse import PmuStateEstimation, pmu_se_solve
    if isinstance(analysis, DcStateEstimation):
        return dc_se_solve(analysis, power=power)
    if isinstance(analysis, PmuStateEstimation):
        return pmu_se_solve(analysis, power=power, current=current)
    if analysis.method.name == "lav":
        from .lav import lav_solve
        return lav_solve(analysis, iteration=iteration, power=power,
                         current=current)

    from ..utils.profiling import Timings, default_timings
    if getattr(analysis.method, "timings", None) is None:
        analysis.method.timings = Timings()
    with analysis.method.timings.span("refresh"), \
            default_timings.span("se.refresh"):
        analysis._refresh_arrays()
    analysis.method.iteration = 0
    kind = analysis.method.factorization \
        if analysis.method.factorization in (linalg.QR, linalg.PW) \
        else linalg.LU
    verbose = 0 if verbose is None else verbose

    if verbose >= 2:
        # reference print/solver.jl verbose tables: stepwise host loop
        from ..report.solver import (print_middle_se, print_residuals_se,
                                     print_solver_se, print_top_se)
        print_top_se(analysis.monitoring, verbose)
        residuals(analysis)
        print_middle_se(analysis.system, analysis, verbose)
        converged = False
        for _ in range(iteration + 1):
            maxinc = increment(analysis)
            vmj = jnp.asarray(analysis.voltage.magnitude)
            vaj = jnp.asarray(analysis.voltage.angle)
            obj = float(_wls_objective(analysis.arrays, analysis.net,
                                       vmj, vaj))
            print_solver_se(analysis.method.iteration, obj, maxinc, verbose)
            if maxinc < tolerance:
                converged = True
                break
            if analysis.method.iteration == iteration:
                break
            solve(analysis)
        residuals(analysis)
        print_residuals_se(analysis.method.residual,
                           analysis.method.precision_diag, verbose)
        analysis.method.converged = converged
        analysis.method.objective = float(_wls_objective(
            analysis.arrays, analysis.net,
            jnp.asarray(analysis.voltage.magnitude),
            jnp.asarray(analysis.voltage.angle)))
        from ..report.solver import print_exit
        print_exit("gauss_newton", converged, not converged,
                   analysis.method.iteration, verbose)
    else:
        vm = jnp.asarray(analysis.voltage.magnitude)
        va = jnp.asarray(analysis.voltage.angle)
        solver = _se_solve_damped if damping else _se_solve
        with analysis.method.timings.span("solve"), \
                default_timings.span("se.solve"):
            vm, va, it, maxinc, converged, relmax = solver(
                analysis.arrays, analysis.net, vm, va, tolerance, iteration,
                kind)
            if kind not in (linalg.QR, linalg.PW) and \
                    float(relmax) > 1e-6 and \
                    analysis.arrays.pair_r1.shape[0] == 0:
                # refinement gate tripped: the f32-factorized gain could
                # not be refined to a trustworthy increment (cond ≳ 1e7 —
                # heavy PMU weight ratios, near-unobservable islands).
                # Escalate to the square-root (QR) method, the reference's
                # own remedy for ill-conditioned normal equations
                # (acStateEstimation.jl:878-931 Orthogonal rationale).
                analysis.method.refine_escalated = True
                vm = jnp.asarray(analysis.voltage.magnitude)
                va = jnp.asarray(analysis.voltage.angle)
                vm, va, it, maxinc, converged, relmax = solver(
                    analysis.arrays, analysis.net, vm, va, tolerance,
                    iteration, linalg.QR)
            # host readbacks block on the device loop: the span measures
            # the full solve, not just the dispatch
            analysis.voltage.magnitude = np.asarray(vm)
            analysis.voltage.angle = np.asarray(va)
        analysis.method.iteration = int(it)
        analysis.method.converged = bool(converged)
        analysis.method.max_increment = float(maxinc)
        analysis.method.refine_residual = float(relmax)
        if verbose:
            from ..report.solver import print_exit
            print_exit("gauss_newton", bool(converged), not bool(converged),
                       int(it), verbose)

    if power:
        from ..postprocessing.ac import power as ac_power
        ac_power(analysis)
    if current:
        from ..postprocessing.ac import current as ac_current
        ac_current(analysis)
    return analysis


def residuals(analysis: AcStateEstimation):
    """Measurement residuals r = z - h(x) at the current state (host)."""
    analysis._refresh_arrays()
    vm = jnp.asarray(analysis.voltage.magnitude)
    va = jnp.asarray(analysis.voltage.angle)
    H, h = _build_h_jit(analysis.arrays, analysis.net, vm, va)
    r = np.asarray(analysis.arrays.mean) - np.asarray(h)
    analysis.method.residual = r
    analysis.method.jacobian = np.asarray(H)
    analysis.method.precision_diag = np.asarray(analysis.arrays.w)
    analysis.method.mean = np.asarray(analysis.arrays.mean)
    return r
