"""LAV (least absolute value) state estimation on the in-house IPM.

The reference builds LAV as a JuMP model with positive/negative deviation
variables per measurement and minimizes their sum, solved by Ipopt
(acStateEstimation.jl:629-853 AC, dcStateEstimation.jl:201-341 DC,
pmuStateEstimation.jl:223-368 PMU). Here the same model —

    min  Σ (u + v)   s.t.  h(x) + u - v = z,  u >= 0, v >= 0

— runs on opf/ipm.py. The AC variant is a nonlinear program (h from the
measurement-row IR); DC and PMU variants are LPs with constant coefficient
matrices. In-service rows only (out-of-service devices drop out), matching
the reference's status handling.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import linalg
from ..powerflow.ac import Polar, compile_ac_arrays
from ..system.model import model
from .acse import (AcStateEstimation, SeMethod, build_h, compile_se_arrays)
from .dcse import Angle, DcSeMethod, DcStateEstimation, compile_dcse_arrays
from .pmuse import (PmuSeMethod, PmuStateEstimation, compile_pmuse_arrays)
from ..opf.ipm import NlpProblem, solve_nlp


def ac_lav_state_estimation(monitoring) -> AcStateEstimation:
    """Reference acLavStateEstimation (acStateEstimation.jl:629-853)."""
    system = monitoring.system
    system.check_slack()
    model(system, "ac")
    n = system.bus.number
    arr, types, row_device = compile_se_arrays(system, monitoring)
    net = compile_ac_arrays(system)
    rev = system.model.revision
    method = SeMethod("lav", linalg.LU)
    method.type = types
    method.row_device = row_device
    return AcStateEstimation(
        system=system, monitoring=monitoring,
        voltage=Polar(system.bus.voltage.magnitude.array[:n].copy(),
                      system.bus.voltage.angle.array[:n].copy()),
        method=method, arrays=arr, net=net,
        signature={"ac_model": rev.ac_model,
                   "measurement": monitoring.revision.measurement,
                   "meas_values": monitoring.revision.values,
                   "slack": rev.slack},
    )


@lru_cache(maxsize=32)
def _ac_lav_fns(n: int, m_act: int):
    """AC LAV problem functions for a given (bus count, active rows)
    shape, params-threaded so repeated solves hit solve_nlp's engine
    cache (per-call closures would pay the full compile/trace budget on
    EVERY solve).

    Analytic derivatives: the LAV equality Jacobian is [H(x), I, -I]
    (+ the slack-anchor row) with H already computed by build_h —
    autodiff over the 2n+2m variables is pure waste, and its eager
    tangent basis materializes 2n+2m copies of the constraint graph."""
    n_x = 2 * n + 2 * m_act
    rng_m = jnp.arange(m_act)

    def split(xx):
        return xx[:2 * n], xx[2 * n:2 * n + m_act], xx[2 * n + m_act:]

    def objective(xx, p):
        _, u, v = split(xx)
        return jnp.sum(u) + jnp.sum(v)

    def eq(xx, p):
        state, u, v = split(xx)
        va, vm = state[:n], state[n:]
        _, h = build_h(p["arr"], p["net"], vm, va)
        resid = h[p["act"]] + u - v - p["z"]
        return jnp.concatenate(
            [resid, (state[p["slack"]] - p["anchor"])[None]])

    def ineq(xx, p):
        _, u, v = split(xx)
        return jnp.concatenate([u, v])

    def jac_eq(xx, p):
        state = xx[:2 * n]
        H, _ = build_h(p["arr"], p["net"], state[n:], state[:n])
        J = jnp.zeros((m_act + 1, n_x))
        J = J.at[:m_act, :2 * n].set(H[p["act"]])
        J = J.at[rng_m, 2 * n + rng_m].set(1.0)
        J = J.at[rng_m, 2 * n + m_act + rng_m].set(-1.0)
        return J.at[m_act, p["slack"]].set(1.0)

    def jac_ineq(xx, p):
        return jnp.zeros((2 * m_act, n_x)).at[
            jnp.arange(2 * m_act), 2 * n + jnp.arange(2 * m_act)].set(1.0)

    def hess(xx, y_raw, z_raw, p):
        # linear objective: ∇²L = -Σ yᵢ ∇²hᵢ(state), state block only
        ye = y_raw[:m_act]

        def weighted_h(state):
            _, h = build_h(p["arr"], p["net"], state[n:], state[:n])
            return -jnp.dot(ye, h[p["act"]])

        hss = jax.hessian(weighted_h)(xx[:2 * n])
        return jnp.zeros((n_x, n_x)).at[:2 * n, :2 * n].set(hss)

    return objective, eq, ineq, jac_eq, jac_ineq, hess


def lav_solve(analysis: AcStateEstimation, iteration: int = 200,
              power: bool = False, current: bool = False,
              tolerance: float = 1e-8):
    """Solve AC LAV via the IPM."""
    analysis._refresh_arrays()
    arr = analysis.arrays
    net = analysis.net
    n = analysis.system.bus.number
    status = np.asarray(arr.status)
    active = np.flatnonzero(status == 1)
    m_act = len(active)
    z = np.asarray(arr.mean)[active]
    slack = int(np.asarray(arr.slack))
    act = jnp.asarray(active)

    objective, eq, ineq, jac_eq, jac_ineq, hess = _ac_lav_fns(n, m_act)
    pl = {"arr": arr, "net": net, "z": jnp.asarray(z), "act": act,
          "slack": jnp.asarray(slack),
          "anchor": jnp.asarray(float(analysis.voltage.angle[slack]))}

    vm0 = np.asarray(analysis.voltage.magnitude)
    va0 = np.asarray(analysis.voltage.angle)
    _, h0 = build_h(arr, net, jnp.asarray(vm0), jnp.asarray(va0))
    r0 = z - np.asarray(h0)[active]
    x0 = np.concatenate([va0, vm0, np.maximum(r0, 0) + 1e-3,
                         np.maximum(-r0, 0) + 1e-3])

    res = solve_nlp(NlpProblem(objective, eq, ineq, jac_eq=jac_eq,
                               jac_ineq=jac_ineq, hess=hess, params=pl,
                               engine_key=("ac_lav", n, m_act)),
                    x0, max_iter=iteration, tol=tolerance)
    analysis.voltage.angle = res.x[:n]
    analysis.voltage.magnitude = res.x[n:2 * n]
    analysis.method.iteration = res.iterations
    analysis.method.converged = res.converged
    analysis.method.objective = res.objective
    if power:
        from ..postprocessing.ac import power as ac_power
        ac_power(analysis)
    if current:
        from ..postprocessing.ac import current as ac_current
        ac_current(analysis)
    return analysis


def dc_lav_state_estimation(monitoring) -> DcStateEstimation:
    """Reference dcLavStateEstimation (dcStateEstimation.jl:201-341)."""
    system = monitoring.system
    system.check_slack()
    model(system, "dc")
    arr, row_device, inservice = compile_dcse_arrays(system, monitoring)
    rev = system.model.revision
    method = DcSeMethod("dc_lav")
    method.row_device = row_device
    method.inservice = inservice
    analysis = DcStateEstimation(
        system=system, monitoring=monitoring,
        voltage=Angle(np.zeros(system.bus.number)),
        method=method, arrays=arr,
        signature={"dc_model": rev.dc_model,
                   "measurement": monitoring.revision.measurement,
                   "meas_values": monitoring.revision.values,
                   "slack": rev.slack},
    )
    return analysis



@lru_cache(maxsize=32)
def _lin_lav_fns(n_state: int, m_act: int, n_extra_eq: int):
    """Linear LAV (DC / PMU) problem functions for a (state size, active
    rows) shape, params-threaded like _ac_lav_fns so re-solves reuse
    solve_nlp's cached engine. ``n_extra_eq`` = 1 appends the DC slack
    anchor row (p["slack"]); the Jacobians ride params as constants."""
    n_x = n_state + 2 * m_act

    def objective(xx, p):
        return jnp.sum(xx[n_state:])

    def eq(xx, p):
        state = xx[:n_state]
        u = xx[n_state:n_state + m_act]
        v = xx[n_state + m_act:]
        resid = p["h"] @ state + u - v - p["z"]
        if n_extra_eq:
            resid = jnp.concatenate([resid, state[p["slack"]][None]])
        return resid

    def ineq(xx, p):
        return xx[n_state:]

    def jac_eq(xx, p):
        return p["je"]

    def jac_ineq(xx, p):
        return p["ji"]

    def hess(xx, yy, zz, p):
        return jnp.zeros((n_x, n_x))

    return objective, eq, ineq, jac_eq, jac_ineq, hess


def dc_lav_solve(analysis: DcStateEstimation, iteration: int = 200,
                 power: bool = False, tolerance: float = 1e-8):
    analysis._refresh_arrays()
    arr = analysis.arrays
    n = analysis.system.bus.number
    h_np = np.asarray(arr.h_dense)
    z_np = np.asarray(arr.mean)
    # rows with any coefficient (in-service)
    active = np.flatnonzero(np.abs(h_np).sum(axis=1) > 0)
    m_act = len(active)
    h_act = jnp.asarray(h_np[active])
    z_act = jnp.asarray(z_np[active])
    slack = int(np.asarray(arr.slack))

    # constant LP derivatives: [h_act, I, -I] + slack row; zero Hessian
    n_x = n + 2 * m_act
    je = np.zeros((m_act + 1, n_x))
    je[:m_act, :n] = h_np[active]
    je[np.arange(m_act), n + np.arange(m_act)] = 1.0
    je[np.arange(m_act), n + m_act + np.arange(m_act)] = -1.0
    je[m_act, slack] = 1.0
    ji = np.zeros((2 * m_act, n_x))
    ji[np.arange(2 * m_act), n + np.arange(2 * m_act)] = 1.0

    objective, eq, ineq, jac_eq, jac_ineq, hess = _lin_lav_fns(
        n, m_act, 1)
    pl = {"h": h_act, "z": z_act, "slack": jnp.asarray(slack),
          "je": jnp.asarray(je), "ji": jnp.asarray(ji)}

    x0 = np.concatenate([np.zeros(n), np.ones(2 * m_act) * 0.1])
    res = solve_nlp(NlpProblem(objective, eq, ineq, jac_eq=jac_eq,
                               jac_ineq=jac_ineq, hess=hess, params=pl,
                               engine_key=("dc_lav", n, m_act)), x0,
                    max_iter=iteration, tol=tolerance)
    analysis.voltage.angle = res.x[:n] + float(arr.slack_angle)
    analysis.method.iteration = res.iterations
    analysis.method.converged = res.converged
    if power:
        from ..postprocessing.dc import power as dc_power
        dc_power(analysis)
    return analysis


def pmu_lav_state_estimation(monitoring) -> PmuStateEstimation:
    """Reference pmuLavStateEstimation (pmuStateEstimation.jl:223-368)."""
    system = monitoring.system
    model(system, "ac")
    arr, inservice = compile_pmuse_arrays(system, monitoring)
    rev = system.model.revision
    method = PmuSeMethod("pmu_lav")
    method.inservice = inservice
    n = system.bus.number
    return PmuStateEstimation(
        system=system, monitoring=monitoring,
        voltage=Polar(np.zeros(n), np.zeros(n)),
        method=method, arrays=arr,
        signature={"ac_model": rev.ac_model,
                   "measurement": monitoring.revision.measurement,
                   "meas_values": monitoring.revision.values},
    )


def pmu_lav_solve(analysis: PmuStateEstimation, iteration: int = 200,
                  power: bool = False, current: bool = False,
                  tolerance: float = 1e-8):
    analysis._refresh_arrays()
    arr = analysis.arrays
    n = analysis.system.bus.number
    h_np = np.asarray(arr.h_dense)
    z_np = np.asarray(arr.mean)
    active = np.flatnonzero(np.abs(h_np).sum(axis=1) > 0)
    m_act = len(active)
    h_act = jnp.asarray(h_np[active])
    z_act = jnp.asarray(z_np[active])

    # constant LP derivatives: [h_act, I, -I]; zero Hessian
    n_x = 2 * n + 2 * m_act
    je = np.zeros((m_act, n_x))
    je[:, :2 * n] = h_np[active]
    je[np.arange(m_act), 2 * n + np.arange(m_act)] = 1.0
    je[np.arange(m_act), 2 * n + m_act + np.arange(m_act)] = -1.0
    ji = np.zeros((2 * m_act, n_x))
    ji[np.arange(2 * m_act), 2 * n + np.arange(2 * m_act)] = 1.0

    objective, eq, ineq, jac_eq, jac_ineq, hess = _lin_lav_fns(
        2 * n, m_act, 0)
    pl = {"h": h_act, "z": z_act,
          "je": jnp.asarray(je), "ji": jnp.asarray(ji)}

    x0 = np.concatenate([np.ones(n), np.zeros(n), 0.1 * np.ones(2 * m_act)])
    res = solve_nlp(NlpProblem(objective, eq, ineq, jac_eq=jac_eq,
                               jac_ineq=jac_ineq, hess=hess, params=pl,
                               engine_key=("pmu_lav", n, m_act)), x0,
                    max_iter=iteration, tol=tolerance)
    re, im = res.x[:n], res.x[n:2 * n]
    analysis.voltage.magnitude = np.hypot(re, im)
    analysis.voltage.angle = np.arctan2(im, re)
    analysis.method.iteration = res.iterations
    analysis.method.converged = res.converged
    if power:
        from ..postprocessing.ac import power as ac_power
        ac_power(analysis)
    if current:
        from ..postprocessing.ac import current as ac_current
        ac_current(analysis)
    return analysis
