"""Bad-data processing: chi-squared test and largest-normalized-residual.

Reference /root/reference/src/stateEstimation/badData.jl. The reference
computes residual covariance diagonals via selected sparse inverses
(Takahashi on CHOLMOD factors / LU reuse, :287-363, :536-911). The dense
device path computes the projection diagonal c = diag(H G⁻¹ Hᵀ) with one
batched mixed-precision solve — the normalized residual is then
|r_i| / sqrt(|R_ii - c_i|); the worst device above the threshold is set
out of service and its row removed (:48-285). ``chi_test`` (:948-995)
compares the WLS objective against the chi-squared quantile at the given
confidence with the reference's per-analysis degrees-of-freedom rules.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import scipy.stats

from ..ops import linalg


@dataclass
class ResidualTest:
    detect: bool = False
    max_normalized_residual: float = 0.0
    label: object = None
    index: int = -1


@dataclass
class ChiTest:
    detect: bool
    treshold: float   # reference field name (sic)
    objective: float


def _projection_diag(h, w, mask_cols=None):
    """c = diag(H G⁻¹ Hᵀ) with G = HᵀWH (+ identity on masked columns)."""
    h = jnp.asarray(h)
    w = jnp.asarray(w)
    n = h.shape[1]
    if mask_cols is not None:
        m = jnp.ones(n).at[jnp.asarray(mask_cols)].set(0.0)
        h = h * m[None, :]
        gain = h.T @ (w[:, None] * h) + jnp.diag(1.0 - m)
    else:
        gain = h.T @ (w[:, None] * h)
    x = linalg.solve(linalg.factorize(gain, linalg.LU), h.T)
    return jnp.sum(h * x.T, axis=1)


def _find_worst(residual, w, c):
    """Largest normalized residual over rows with nonzero residual."""
    denom = np.sqrt(np.abs(1.0 / np.asarray(w) - np.asarray(c)))
    rn = np.where(residual != 0.0,
                  np.abs(residual) / np.maximum(denom, 1e-30), 0.0)
    idx = int(np.argmax(rn))
    return idx, float(rn[idx])


def _deactivate(monitoring, kind: str, device_idx: int):
    """Set one device out of service AND bump the measurement revision —
    without the bump the live analysis' signature check keeps the stale
    row snapshot and the LNR loop re-detects the same outlier forever."""
    label = _deactivate_raw(monitoring, kind, device_idx)
    monitoring.changed_values()
    return label


def _deactivate_raw(monitoring, kind: str, device_idx: int):
    if kind == "voltmeter":
        monitoring.voltmeter.magnitude.status[device_idx] = 0
        return monitoring.voltmeter.label.label(device_idx)
    if kind == "ammeter":
        monitoring.ammeter.magnitude.status[device_idx] = 0
        return monitoring.ammeter.label.label(device_idx)
    if kind == "wattmeter":
        monitoring.wattmeter.active.status[device_idx] = 0
        return monitoring.wattmeter.label.label(device_idx)
    if kind == "varmeter":
        monitoring.varmeter.reactive.status[device_idx] = 0
        return monitoring.varmeter.label.label(device_idx)
    if kind == "pmu":
        monitoring.pmu.magnitude.status[device_idx] = 0
        monitoring.pmu.angle.status[device_idx] = 0
        return monitoring.pmu.label.label(device_idx)
    raise ValueError(kind)


def residual_test(analysis, threshold: float = 3.0,
                  sparse: bool | None = None) -> ResidualTest:
    """Reference residualTest! — dispatches on the analysis type.

    ``sparse`` selects the Takahashi selected-inverse path for the
    residual-covariance diagonal (auto above ~1500 state variables,
    matching the reference's sparse-factor reuse at scale)."""
    import scipy.sparse as sp

    from .acse import AcStateEstimation, residuals
    from .dcse import DcStateEstimation
    from .pmuse import PmuStateEstimation
    from .takahashi import projection_diag_sparse

    bad = ResidualTest()
    monitoring = analysis.monitoring

    if isinstance(analysis, AcStateEstimation):
        residuals(analysis)
        h = analysis.method.jacobian
        w = analysis.method.precision_diag
        r = analysis.method.residual * np.asarray(analysis.arrays.status)
        slack = int(np.asarray(analysis.arrays.slack))
        use_sparse = sparse if sparse is not None else h.shape[1] > 1500
        if use_sparse:
            c = projection_diag_sparse(sp.csr_matrix(h), w,
                                       mask_cols=[slack])
        else:
            c = np.asarray(_projection_diag(h, w, mask_cols=[slack]))
        idx, rn = _find_worst(r, w, c)
        bad.index = idx
        bad.max_normalized_residual = rn
        kind, dev = analysis.method.row_device[idx]
    elif isinstance(analysis, DcStateEstimation):
        h = np.asarray(analysis.arrays.h_dense)
        w = np.asarray(analysis.arrays.w)
        r = np.asarray(analysis.arrays.mean) - h @ np.asarray(
            analysis.voltage.angle)
        slack = int(np.asarray(analysis.arrays.slack))
        c = np.asarray(_projection_diag(h, w, mask_cols=[slack]))
        idx, rn = _find_worst(r, w, c)
        bad.index = idx
        bad.max_normalized_residual = rn
        kind, dev = analysis.method.row_device[idx]
    elif isinstance(analysis, PmuStateEstimation):
        h = np.asarray(analysis.arrays.h_dense)
        w = np.asarray(analysis.arrays.w)
        vm = np.asarray(analysis.voltage.magnitude)
        va = np.asarray(analysis.voltage.angle)
        state = np.concatenate([vm * np.cos(va), vm * np.sin(va)])
        r = np.asarray(analysis.arrays.mean) - h @ state
        r[np.abs(h).sum(axis=1) == 0] = 0.0
        c = np.asarray(_projection_diag(h, w))
        idx, rn = _find_worst(r, w, c)
        bad.index = idx
        bad.max_normalized_residual = rn
        kind, dev = "pmu", idx // 2
    else:
        raise TypeError(f"unsupported analysis {type(analysis)}")

    if rn > threshold:
        bad.detect = True
        bad.label = _deactivate(monitoring, kind, dev)
    else:
        if kind == "pmu":
            bad.label = monitoring.pmu.label.label(dev)
        else:
            bad.label = getattr(monitoring, kind).label.label(dev)
    return bad


@partial(jax.jit, static_argnames=("max_remove", "max_iter"))
def _lnr_fused(arr, net, vm0, va0, row_group, threshold, tol,
               max_remove: int, max_iter: int):
    """Device-side LNR loop: solve -> normalized residuals -> deactivate
    the worst device's rows -> re-solve, as ONE jitted nested while_loop.

    The host-driven loop (residual_test + state_estimation per removal)
    pays hundreds of device dispatches plus a dense readback per round;
    fused, the whole detect-remove-resolve cycle is a single
    device program over the live row-status vector (the value-patch
    semantics of measurement deactivation, acse.py:157-169). Returns
    (vm, va, removed_rows[max_remove] (-1 padded), n_removed,
    last_max_rn)."""
    from .acse import build_h, gn_increment
    from ..ops import linalg as _lin

    n = vm0.shape[0]
    col_mask = jnp.ones(2 * n).at[arr.slack].set(0.0)

    def solve(status, vm, va):
        a = arr._replace(status=status)
        dx, maxinc, _ = gn_increment(a, net, vm, va, _lin.LU)

        def cond(c):
            _, _, _, mi, it = c
            return (mi >= tol) & (it < max_iter)

        def body(c):
            vm, va, dx, _, it = c
            va = va + dx[:n]
            vm = vm + dx[n:]
            dx, mi, _ = gn_increment(a, net, vm, va, _lin.LU)
            return vm, va, dx, mi, it + 1

        vm, va, _, _, _ = jax.lax.while_loop(
            cond, body, (vm, va, dx, maxinc, jnp.int64(0)))
        return vm, va

    def detect(status, vm, va):
        a = arr._replace(status=status)
        H, h = build_h(a, net, vm, va)
        Hm = H * col_mask[None, :]
        r = (a.mean - h) * status
        gain = Hm.T @ (a.w[:, None] * Hm) + jnp.diag(1.0 - col_mask)
        x = _lin.solve(_lin.factorize(gain, _lin.LU), Hm.T)
        c = jnp.sum(Hm * x.T, axis=1)
        denom = jnp.sqrt(jnp.abs(1.0 / a.w - c))
        rn = jnp.where((r != 0.0) & (status > 0.0),
                       jnp.abs(r) / jnp.maximum(denom, 1e-30), 0.0)
        idx = jnp.argmax(rn)
        return idx, rn[idx]

    def cond(carry):
        return carry[-1]

    def body(carry):
        status, vm, va, removed, k, rn_last, _ = carry
        vm, va = solve(status, vm, va)
        idx, rn_max = detect(status, vm, va)
        det = rn_max > threshold
        status = jnp.where(det, status * (row_group != row_group[idx]),
                           status)
        removed = removed.at[k].set(jnp.where(det, idx, -1))
        k = k + det.astype(jnp.int64)
        return (status, vm, va, removed, k, rn_max,
                det & (k < max_remove))

    removed0 = jnp.full(max_remove, -1, dtype=jnp.int64)
    carry = (arr.status, vm0, va0, removed0, jnp.int64(0),
             jnp.asarray(jnp.inf), jnp.asarray(True))
    status, vm, va, removed, k, rn_last, _ = jax.lax.while_loop(
        cond, body, carry)
    # if the loop exited on the removal cap, the final set is unsolved —
    # one more (cheap, already-converged otherwise) solve leaves the
    # state consistent with the surviving measurement set
    vm, va = solve(status, vm, va)
    return vm, va, removed, k, rn_last


def lnr_removal(analysis, threshold: float = 3.0, max_remove: int = 10,
                tolerance: float = 1e-8, max_iter: int = 40):
    """Fused largest-normalized-residual correction for AC WLS SE.

    Equivalent to the reference usage pattern of calling
    ``residualTest!`` + ``stateEstimation!`` in a loop
    (badData.jl:48-285) until no outlier remains, but executed as one
    device program (see _lnr_fused). Deactivates the flagged devices in
    the monitoring set, leaves ``analysis`` solved on the surviving
    rows, and returns the list of removed device labels."""
    from .acse import AcStateEstimation

    if not isinstance(analysis, AcStateEstimation):
        raise TypeError("lnr_removal supports AC WLS state estimation")
    analysis._refresh_arrays()
    arr = analysis.arrays
    # rows of the same physical device share a group id so a detection
    # removes the whole device (both PMU rows), matching _deactivate
    groups = {}
    row_group = np.empty(len(analysis.method.row_device), dtype=np.int64)
    for i, kd in enumerate(analysis.method.row_device):
        row_group[i] = groups.setdefault(kd, len(groups))
    n = analysis.system.bus.number
    vm0 = jnp.asarray(np.asarray(analysis.voltage.magnitude,
                                 dtype=float)[:n])
    va0 = jnp.asarray(np.asarray(analysis.voltage.angle,
                                 dtype=float)[:n])
    vm, va, removed, k, _ = _lnr_fused(
        arr, analysis.net, vm0, va0, jnp.asarray(row_group),
        jnp.asarray(float(threshold)), jnp.asarray(float(tolerance)),
        max_remove, max_iter)
    removed = np.asarray(removed)[:int(k)]
    labels = []
    for row in removed:
        kind, dev = analysis.method.row_device[int(row)]
        labels.append(_deactivate_raw(analysis.monitoring, kind, dev))
    if labels:
        analysis.monitoring.changed_values()
        # the device loop already solved on the surviving set; absorb the
        # revision bump so the next _refresh_arrays keeps this snapshot
        analysis._refresh_arrays()
    analysis.voltage.magnitude = np.asarray(vm)
    analysis.voltage.angle = np.asarray(va)
    analysis.method.converged = True
    return labels


def chi_test(analysis, confidence: float = 0.95) -> ChiTest:
    """Reference chiTest (badData.jl:948-995)."""
    from .acse import AcStateEstimation, residuals
    from .dcse import DcStateEstimation
    from .pmuse import PmuStateEstimation

    system = analysis.system
    n = system.bus.number

    if isinstance(analysis, AcStateEstimation):
        residuals(analysis)
        r = analysis.method.residual * np.asarray(analysis.arrays.status)
        w = analysis.method.precision_diag
        objective = float(np.sum(r * r * w))
        off = np.asarray(analysis.arrays.pair_off)
        if off.size:
            r1 = np.asarray(analysis.arrays.pair_r1)
            r2 = np.asarray(analysis.arrays.pair_r2)
            objective += float(np.sum(2 * r[r1] * r[r2] * off))
        inservice = int(np.asarray(analysis.arrays.status).sum())
        df = inservice - 2 * n + 1
    elif isinstance(analysis, DcStateEstimation):
        h = np.asarray(analysis.arrays.h_dense)
        r = np.asarray(analysis.arrays.mean) - h @ np.asarray(
            analysis.voltage.angle)
        w = np.asarray(analysis.arrays.w)
        objective = float(np.sum(r * r * w))
        df = analysis.method.inservice - n + 1
    elif isinstance(analysis, PmuStateEstimation):
        h = np.asarray(analysis.arrays.h_dense)
        vm = np.asarray(analysis.voltage.magnitude)
        va = np.asarray(analysis.voltage.angle)
        state = np.concatenate([vm * np.cos(va), vm * np.sin(va)])
        r = np.asarray(analysis.arrays.mean) - h @ state
        r[np.abs(h).sum(axis=1) == 0] = 0.0
        w = np.asarray(analysis.arrays.w)
        objective = float(np.sum(r * r * w))
        df = analysis.method.inservice - 2 * n
    else:
        raise TypeError(f"unsupported analysis {type(analysis)}")

    chi = float(scipy.stats.chi2.ppf(confidence, max(df, 1)))
    return ChiTest(objective >= chi, chi, objective)
