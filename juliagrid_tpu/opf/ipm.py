"""Primal-dual interior-point method for NLP/QP/LP, in JAX.

This is the framework's own optimizer — the component the reference
delegates to Ipopt/HiGHS/GLPK through JuMP (SURVEY §2: "the build's hardest
component"; the native boundary at acOptimalPowerFlow.jl:333). It solves

    min f(x)   s.t.  c_E(x) = 0,   c_I(x) >= 0

with slacks s > 0 on the inequalities and a log-barrier, following the
Ipopt algorithm (Wächter & Biegler, Math. Prog. 106, 2006):

- damped Newton on the primal-dual system condensed to the augmented form

      [ W + J_Iᵀ Σ J_I + δI   J_Eᵀ ] [ dx ]   [ -r_d ]
      [ J_E                  -δc I ] [ -dy ] = [ -c_E ],      Σ = Z S⁻¹

- **filter line search** on the pair (θ, φ) = (constraint violation,
  barrier objective) with the switching/Armijo rule, instead of a single
  penalty merit function — penalty parameters are what made the round-1
  monotone scheme creep (30–60 iterations; Ipopt does ~20);
- **second-order corrections** when the first trial step increases θ;
- monotone Fiacco-McCormick barrier with the superlinear decrease
  μ ← max(ε/11, min(κ_μ μ, μ^{θ_μ})) gated on the scaled KKT error;
- inertia-free regularization: δ escalates until the condensed system has
  positive curvature along dx and the linear solve is trustworthy;
- a **feasibility-restoration phase** (Levenberg–Marquardt on the
  constraint violation) entered when the backtracking trust collapses.

Derivatives (gradients, constraint Jacobians, exact Lagrangian Hessian)
come from JAX autodiff; the augmented solve is the mixed-precision dense
path (ops/linalg.py: f32 factorization + f64 iterative refinement), which
is why the KKT matrix is Jacobi-equilibrated before factorization.

The per-iteration step is one jitted function; the outer loop runs on host
(tens of iterations). ``vmap`` over problem data enables batched OPF.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import linalg

# Wächter-Biegler constants (their Table 1 defaults)
KAPPA_EPS = 10.0      # barrier decrease gate: E_mu <= KAPPA_EPS * mu
KAPPA_MU = 0.2        # linear mu decrease factor
THETA_MU = 1.5        # superlinear mu decrease exponent
GAMMA_THETA = 1e-5    # filter margin on theta
GAMMA_PHI = 1e-5      # filter margin on phi
ETA_PHI = 1e-4        # Armijo constant
S_THETA = 1.1         # switching-condition exponents
S_PHI = 2.3
DELTA_SW = 1.0        # switching-condition scale
KAPPA_SOC = 0.99      # SOC progress requirement
MAX_SOC = 2           # second-order corrections per iteration
GAMMA_ALPHA = 0.05    # alpha_min safety factor
KAPPA_SIGMA = 1e10    # dual projection band around the central path


@dataclass
class NlpProblem:
    """Problem functions (all jax-traceable, x is a flat f64 vector).

    When ``params`` is set, the three callables take ``(x, params)`` and
    the params pytree is threaded through every jitted function as a
    runtime argument instead of being baked into the trace as constants.
    Numeric model edits (bounds, cost coefficients, demands) then re-solve
    with an XLA compile-cache hit — the live-edit economics of the
    reference's JuMP model patching (optimalPowerFlow/utility.jl:525-700)
    without rebuilding or recompiling anything.
    """

    objective: Callable            # x -> scalar, or (x, p) -> scalar
    eq: Optional[Callable] = None  # x -> (mE,) residuals, target 0
    ineq: Optional[Callable] = None  # x -> (mI,) values, constraint >= 0
    params: Optional[object] = None  # pytree threaded as runtime arg
    # analytic Jacobians (x -> (m, n_x), same calling convention as the
    # constraint functions). When a model computes its Jacobian anyway —
    # LAV's equality rows are [H(x), I, -I] with H from build_h — autodiff
    # (n_x basis tangents through the whole constraint graph) is pure
    # memory/time waste: the eager jacfwd of the LAV equalities
    # materializes n_x copies of the constraint graph.
    jac_eq: Optional[Callable] = None
    jac_ineq: Optional[Callable] = None
    # optional re-boxing hook: np.ndarray -> np.ndarray (may mutate in
    # place and return its argument). Called on the iterate after the
    # start-with-restoration phase, which minimizes the violation of ALL
    # constraints jointly and routinely leaves simple-bound rows a hair
    # outside their boxes — slacks then start at the positivity floor and
    # fraction-to-boundary caps every step (the 118-bus linear-cost DC
    # OPF death spiral, round-4 anchor-test finding). The problem knows
    # its own bound structure; the solver does not.
    push_inside: Optional[Callable] = None
    # analytic Lagrangian Hessian (x, y, z) -> (n_x, n_x) of the RAW
    # problem:  ∇²f - Σ y_i ∇²c_E,i - Σ z_j ∇²c_I,j.  The solver maps its
    # internal scaled duals into raw space before calling and rescales the
    # result, so the callable never sees the scaling. For LPs (DC/PMU LAV)
    # it is identically zero and skipping the chunked autodiff pass saves
    # the dominant per-iteration cost; for AC OPF it is the classic polar
    # power-flow Hessian.
    hess: Optional[Callable] = None
    # optional structured KKT solver (opf/kkt_bbd.AcKktBbd protocol):
    #   solve(x, y, z, sigma, delta, rhs_x, rhs_e, pk)
    #     -> (dx, v, lin_res, curv)  [v = -dy, same sign convention as
    #        the dense augmented solve]
    #   row_maxes(x, p) -> (rme, rmi) raw per-row Jacobian maxima
    # When set, the Newton step never materializes the dense
    # (n_x+m_E)² KKT matrix — the solver assembles and factorizes it in
    # bordered-block-diagonal form (the scale path past ~3k buses).
    kkt: Optional[object] = None
    # opt-in engine reuse: when set, solve_nlp caches every traced/jitted
    # function under (engine_key, n_x, m_e, m_i) and reuses them across
    # solves — ONLY valid when the callables are pure in (x, params),
    # i.e. every numeric AND structural datum they read flows through the
    # params pytree or is pinned by the key. Problems whose functions
    # read mutable Python state at trace time (the in-place-edited OPF
    # specs) must leave this None: a cached trace would silently bake the
    # pre-edit structure (the round-5 fix/set_bound regression).
    engine_key: Optional[tuple] = None


@dataclass
class IpmResult:
    x: np.ndarray
    y: np.ndarray          # equality duals
    z: np.ndarray          # inequality duals
    s: np.ndarray          # slacks
    objective: float
    converged: bool
    iterations: int
    kkt_error: float
    # "optimal": KKT error < tol; "acceptable": stopped at an Ipopt-style
    # acceptable point (degenerate active set, KKT error < acceptable_tol);
    # "failed": no acceptable iterate found.
    status: str = "optimal"
    # True once a Newton system was solved by the full-f64 endgame
    # factorization (the f32 path's linear residual check failed)
    f64_endgame: bool = False


# problems larger than this get chunked derivative evaluation: a plain
# jacfwd/hessian materializes all n_x tangents at once, and its forward-pass
# intermediates scale as n_x * |graph| — at pegase size (n_x ~ 3.2k, graph
# intermediates ~ nnz-sized) that is multiple GB of HLO temps
_CHUNK_THRESHOLD = 768
_CHUNK_BLOCK = 256


def _chunked_jacfwd(fn, n_x: int, block: int = _CHUNK_BLOCK):
    """Forward-mode Jacobian evaluated ``block`` tangents at a time.

    ``lax.map`` over tangent blocks bounds peak intermediate memory at
    block/n_x of a full ``jax.jacfwd`` while compiling a single block
    program. ``fn(x, *rest)`` must return a 1-D vector; the result matches
    ``jax.jacfwd(fn)(x, *rest)`` (shape (m, n_x))."""
    nb = -(-n_x // block)

    def jac(x, *rest):
        def one_block(start):
            cols = start + jnp.arange(block)
            vs = (cols[:, None] == jnp.arange(n_x)[None, :]).astype(x.dtype)
            return jax.vmap(
                lambda v: jax.jvp(lambda xx: fn(xx, *rest), (x,), (v,))[1]
            )(vs)
        rows = jax.lax.map(one_block, jnp.arange(nb) * block)
        return rows.reshape(nb * block, -1)[:n_x].T

    return jac


def _make_fns(f, c_e, c_i, n_x: int, m_e: int, m_i: int,
              jac_e_fn=None, jac_i_fn=None, hess_fn=None, kkt_obj=None):
    """All of ``f``/``c_e``/``c_i`` take ``(x, p)`` with ``p`` a runtime
    params pytree (possibly an empty tuple). ``jac_e_fn``/``jac_i_fn``/
    ``hess_fn`` are optional analytic derivatives (same convention) that
    replace the autodiff fallbacks."""
    if not m_e:
        c_e = lambda x, p: jnp.zeros(0)  # noqa: E731
    if not m_i:
        c_i = lambda x, p: jnp.zeros(0)  # noqa: E731

    grad_f = jax.grad(f)
    big = n_x > _CHUNK_THRESHOLD
    if jac_e_fn is not None and m_e:
        jac_e = jac_e_fn
    elif big:
        jac_e = _chunked_jacfwd(c_e, n_x)
    else:
        jac_e = jax.jacfwd(c_e)
    if jac_i_fn is not None and m_i:
        jac_i = jac_i_fn
    elif big:
        jac_i = _chunked_jacfwd(c_i, n_x)
    else:
        jac_i = jax.jacfwd(c_i)

    def lagrangian(x, y, z, p):
        val = f(x, p)
        if m_e:
            val = val - y @ c_e(x, p)
        if m_i:
            val = val - z @ c_i(x, p)
        return val

    grad_l = jax.grad(lagrangian)
    if hess_fn is not None:
        hess_l = hess_fn
    elif big:
        hess_l = _chunked_jacfwd(grad_l, n_x)  # symmetric: Jᵀ of ∇L is H
    else:
        hess_l = jax.jacfwd(grad_l)

    def _vjp(fn, x, p, cot):
        """fnᵀ-Jacobian action Jᵀ·cot without materializing J."""
        _, pull = jax.vjp(lambda xx: fn(xx, p), x)
        return pull(cot)[0]

    @jax.jit
    def metrics(x, s, mu, p):
        """Objective, violation theta, barrier phi, raw residual vectors."""
        fval = f(x, p)
        ce = c_e(x, p)
        ci = c_i(x, p)
        theta = jnp.sum(jnp.abs(ce))
        phi = fval
        ri = ci - s
        if m_i:
            theta = theta + jnp.sum(jnp.abs(ri))
            phi = phi - mu * jnp.sum(jnp.log(jnp.maximum(s, 1e-300)))
        return fval, theta, phi, ce, ri

    @jax.jit
    def kkt_error(x, y, z, s, mu, p):
        """Ipopt's scaled optimality error E_mu (their eq. 5)."""
        r_d = grad_f(x, p)
        dual_l1 = 0.0
        if m_e:
            r_d = r_d - _vjp(c_e, x, p, y)
            dual_l1 = dual_l1 + jnp.sum(jnp.abs(y))
        if m_i:
            r_d = r_d - _vjp(c_i, x, p, z)
            dual_l1 = dual_l1 + jnp.sum(jnp.abs(z))
        s_max = 100.0
        m_tot = max(m_e + m_i, 1)
        s_d = jnp.maximum(s_max, dual_l1 / m_tot) / s_max
        err = jnp.max(jnp.abs(r_d)) / s_d
        if m_e:
            err = jnp.maximum(err, jnp.max(jnp.abs(c_e(x, p))))
        if m_i:
            err = jnp.maximum(err, jnp.max(jnp.abs(c_i(x, p) - s)))
            s_c = jnp.maximum(
                s_max, jnp.sum(jnp.abs(z)) / max(m_i, 1)) / s_max
            err = jnp.maximum(err, jnp.max(jnp.abs(s * z - mu)) / s_c)
        return err

    # E_mu at a whole LADDER of barrier values in one device call: the
    # host loop's Fiacco-McCormick mu walk would otherwise pay one device
    # round trip per candidate mu per iteration
    kkt_error_multi = jax.jit(jax.vmap(
        kkt_error, in_axes=(None, None, None, None, 0, None)))

    @jax.jit
    def metrics_p(x, s, mu, p):
        """metrics with the scalars packed into one array (single
        readback): [fval, theta, phi, max(ri)]."""
        fval, theta, phi, ce, ri = metrics(x, s, mu, p)
        max_ri = jnp.max(ri) if m_i else jnp.asarray(0.0)
        return jnp.stack([fval, theta, phi, max_ri]), ce, ri

    @jax.jit
    def ls_probe(x, s, mu, dx_t, ds_t, alphas, p):
        """(theta, phi) at EVERY backtracking trial point in one call —
        the filter line search walks the results host-side without
        further dispatches."""
        def one(a):
            x_t = x + a * dx_t
            s_t = jnp.maximum(s + a * ds_t, 1e-300) if m_i else s
            _, theta, phi, _, _ = metrics(x_t, s_t, mu, p)
            return theta, phi
        return jax.vmap(one)(alphas)

    @jax.jit
    def kkt_components(x, y, z, s, mu, p):
        """Diagnostic split of E_mu: (scaled dual residual, worst
        stationarity row, primal violation, scaled complementarity, worst
        complementarity row) — which term pins the error decides the
        remedy (dual recovery vs central-path repair)."""
        r_d = grad_f(x, p)
        dual_l1 = 0.0
        if m_e:
            r_d = r_d - _vjp(c_e, x, p, y)
            dual_l1 = dual_l1 + jnp.sum(jnp.abs(y))
        if m_i:
            r_d = r_d - _vjp(c_i, x, p, z)
            dual_l1 = dual_l1 + jnp.sum(jnp.abs(z))
        s_max = 100.0
        m_tot = max(m_e + m_i, 1)
        s_d = jnp.maximum(s_max, dual_l1 / m_tot) / s_max
        prim = jnp.asarray(0.0)
        if m_e:
            prim = jnp.maximum(prim, jnp.max(jnp.abs(c_e(x, p))))
        comp = jnp.asarray(0.0)
        comp_row = jnp.asarray(0)
        if m_i:
            prim = jnp.maximum(prim, jnp.max(jnp.abs(c_i(x, p) - s)))
            s_c = jnp.maximum(
                s_max, jnp.sum(jnp.abs(z)) / max(m_i, 1)) / s_max
            cv = jnp.abs(s * z - mu) / s_c
            comp = jnp.max(cv)
            comp_row = jnp.argmax(cv)
        return (jnp.max(jnp.abs(r_d)) / s_d, jnp.argmax(jnp.abs(r_d)),
                prim, comp, comp_row)

    def _make_step(kkt_solver):
        return jax.jit(partial(_step_body, kkt_solver))

    def _step_body(kkt_solver, x, y, z, s, mu, delta, ce, ri, p):
        """Newton step on the condensed barrier KKT system.

        ``ce``/``ri`` are the equality and inequality-minus-slack residual
        vectors used on the right-hand side; passing them in lets a
        second-order correction reuse this exact compiled graph with the
        Wächter-Biegler corrected residuals. ``kkt_solver(kkt_s, rhs_s)``
        solves the equilibrated system: the f32 factorization + f64
        refinement normally, the full-f64 LU when the outer loop detects
        the f32 precision wall (endgame active sets push the equilibrated
        KKT's condition past what f32 backward error allows — the pegase
        endgame).
        """
        w = hess_l(x, y, z, p)
        g = grad_f(x, p)

        r_d = g
        if m_e:
            je = jac_e(x, p)
            r_d = r_d - je.T @ y
        if m_i:
            ji = jac_i(x, p)
            r_d = r_d - ji.T @ z
            sigma = jnp.clip(z / s, 1e-12, 1e12)
            w = w + ji.T @ (sigma[:, None] * ji)
            # folded RHS contribution:  Jiᵀ (Σ r_i + z - μ/s)
            r_d = r_d + ji.T @ (sigma * ri + z - mu / s)

        n_aug = n_x + m_e
        kkt = jnp.zeros((n_aug, n_aug))
        w_reg = w + delta * jnp.eye(n_x)
        kkt = kkt.at[:n_x, :n_x].set(w_reg)
        rhs = jnp.zeros(n_aug)
        rhs = rhs.at[:n_x].set(-r_d)
        if m_e:
            kkt = kkt.at[:n_x, n_x:].set(je.T)
            kkt = kkt.at[n_x:, :n_x].set(je)
            kkt = kkt.at[n_x:, n_x:].set(-1e-10 * jnp.eye(m_e))
            rhs = rhs.at[n_x:].set(-ce)

        # symmetric Jacobi equilibration: the barrier term Σ = Z/S spans
        # ~1e12 near convergence, far beyond what the f32 factorization
        # plus refinement tolerates (cond must stay ~< 1e7 for IR to
        # converge); D A D compresses the dynamic range to O(1)
        d = 1.0 / jnp.sqrt(jnp.maximum(jnp.max(jnp.abs(kkt), axis=1), 1e-12))
        kkt_s = d[:, None] * kkt * d[None, :]
        sol = d * kkt_solver(kkt_s, d * rhs)
        # linear-solve quality: a silently failed f32 factorization shows up
        # as a large relative residual — the driver escalates delta then
        lin_res = jnp.max(jnp.abs(kkt @ sol - rhs)) / (
            1.0 + jnp.max(jnp.abs(rhs)))
        dx = sol[:n_x]
        dy = -sol[n_x:] if m_e else jnp.zeros(0)

        # inertia-free curvature test (Chiang & Zavala): the condensed
        # Hessian must have positive curvature along dx, else the step can
        # be an ascent/saddle direction and delta must grow
        curv = dx @ (w_reg @ dx)

        if m_i:
            ds = ji @ dx + ri
            dz = (mu - s * z - z * ds) / s
            tau = jnp.maximum(0.99, 1.0 - mu)
            alpha_s = jnp.min(jnp.where(ds < 0, -tau * s / ds, 1.0))
            alpha_z = jnp.min(jnp.where(dz < 0, -tau * z / dz, 1.0))
            alpha_s = jnp.clip(alpha_s, 0.0, 1.0)
            alpha_z = jnp.clip(alpha_z, 0.0, 1.0)
            dphi = g @ dx - mu * jnp.sum(ds / s)
        else:
            ds = jnp.zeros(0)
            dz = jnp.zeros(0)
            alpha_s = jnp.asarray(1.0)
            alpha_z = jnp.asarray(1.0)
            dphi = g @ dx

        # scalar diagnostics packed into ONE array: the host loop reads
        # them with a single device->host transfer per step
        stats = jnp.stack([
            alpha_s, alpha_z, lin_res, curv, dphi, dx @ dx,
            jnp.all(jnp.isfinite(dx)).astype(dx.dtype)])
        return dx, dy, ds, dz, stats

    step = _make_step(
        lambda kkt_s, rhs_s: linalg.solve(
            linalg.factorize(kkt_s, linalg.LU), rhs_s))
    # endgame fallback: full-f64 LU of the regularized KKT
    # (linalg.solve_f64_sqd). Compiled lazily — only solves that actually hit the f32 wall pay
    # its compile.
    step_f64 = _make_step(
        lambda kkt_s, rhs_s: linalg.solve_f64_sqd(kkt_s, rhs_s, refine=1))

    if kkt_obj is not None:
        # structured override: same signature/semantics as the dense step
        # above, but the augmented system is assembled and factorized in
        # BBD form by kkt_obj and all matrix-vector products are
        # vjp/jvp — nothing (m, n_x)-dense is ever materialized. The
        # endgame fallback routes the same assembly through the full-f64
        # LU Schur path (AcKktBbd.solve_f64), so the f32 precision wall
        # has an exit on the scale path too; it compiles lazily, only if a solve actually hits the wall.
        def _bbd_step_body(kkt_solve, x, y, z, s, mu, delta, ce, ri, p):
            g = grad_f(x, p)
            r_d = g
            if m_e:
                r_d = r_d - _vjp(c_e, x, p, y)
            if m_i:
                sigma = jnp.clip(z / s, 1e-12, 1e12)
                r_d = r_d - _vjp(c_i, x, p, z)
                r_d = r_d + _vjp(c_i, x, p, sigma * ri + z - mu / s)
            else:
                sigma = jnp.zeros(0)
            rhs_e = -ce if m_e else jnp.zeros(0)
            dx, v, lin_res, curv = kkt_solve(
                x, y, z, sigma, delta, -r_d, rhs_e, p)
            dy = -v if m_e else jnp.zeros(0)
            if m_i:
                ds = jax.jvp(lambda xx: c_i(xx, p), (x,), (dx,))[1] + ri
                dz = (mu - s * z - z * ds) / s
                tau = jnp.maximum(0.99, 1.0 - mu)
                alpha_s = jnp.clip(
                    jnp.min(jnp.where(ds < 0, -tau * s / ds, 1.0)),
                    0.0, 1.0)
                alpha_z = jnp.clip(
                    jnp.min(jnp.where(dz < 0, -tau * z / dz, 1.0)),
                    0.0, 1.0)
                dphi = g @ dx - mu * jnp.sum(ds / s)
            else:
                ds = jnp.zeros(0)
                dz = jnp.zeros(0)
                alpha_s = jnp.asarray(1.0)
                alpha_z = jnp.asarray(1.0)
                dphi = g @ dx
            stats = jnp.stack([
                alpha_s, alpha_z, lin_res, curv, dphi, dx @ dx,
                jnp.all(jnp.isfinite(dx)).astype(dx.dtype)])
            return dx, dy, ds, dz, stats

        step = jax.jit(partial(_bbd_step_body, kkt_obj.solve))  # noqa: F811
        step_f64 = jax.jit(partial(_bbd_step_body, kkt_obj.solve_f64))

    @jax.jit
    def resto_step(x, lam, p):
        """Levenberg-Marquardt step for min ½‖c_E‖² + ½‖min(c_I,0)‖²."""
        r_parts = []
        j_parts = []
        if m_e:
            r_parts.append(c_e(x, p))
            j_parts.append(jac_e(x, p))
        if m_i:
            ci = c_i(x, p)
            viol = jnp.minimum(ci, 0.0)
            r_parts.append(viol)
            j_parts.append(jnp.where((ci < 0.0)[:, None], jac_i(x, p), 0.0))
        r = jnp.concatenate(r_parts)
        jmat = jnp.concatenate(j_parts, axis=0)
        a = jmat.T @ jmat + lam * jnp.eye(n_x)
        g = jmat.T @ r
        d = 1.0 / jnp.sqrt(jnp.maximum(jnp.max(jnp.abs(a), axis=1), 1e-12))
        a_s = d[:, None] * a * d[None, :]
        dx = -d * linalg.solve(linalg.factorize(a_s, linalg.LU), d * g)
        return dx, 0.5 * (r @ r)

    return step, step_f64, kkt_error, metrics, resto_step, \
        (c_e, c_i, grad_f, jac_e, jac_i, kkt_components,
         kkt_error_multi, metrics_p, ls_probe)


def _filter_accepts(filt, theta, phi):
    for th_f, ph_f in filt:
        if theta >= th_f and phi >= ph_f:
            return False
    return True


class _Engine:
    """Every traced/jitted function one NlpProblem solve needs.

    Built once per problem STRUCTURE and cached (LRU below) keyed on the
    identity of the user callables + shapes: a re-solve with the same
    functions (live edits through the params pytree, warm re-runs of the
    same analysis shape, the bench's measure-after-warmup pattern) reuses
    every compiled executable instead of re-tracing and re-compiling ~10
    graphs, which dominates the wall of a small solve such as the
    118-bus LAV."""

    def __init__(self, problem: "NlpProblem", n_x: int, m_e: int,
                 m_i: int):
        if problem.params is not None:
            f_raw = problem.objective
            eq_raw, ineq_raw = problem.eq, problem.ineq
            je_raw, ji_raw = problem.jac_eq, problem.jac_ineq
            hess_raw = problem.hess
        else:
            obj0, eq0, in0 = problem.objective, problem.eq, problem.ineq
            je0, ji0, h0 = problem.jac_eq, problem.jac_ineq, problem.hess
            f_raw = lambda xx, pp: obj0(xx)  # noqa: E731
            eq_raw = (lambda xx, pp: eq0(xx)) if eq0 else None
            ineq_raw = (lambda xx, pp: in0(xx)) if in0 else None
            je_raw = (lambda xx, pp: je0(xx)) if je0 else None
            ji_raw = (lambda xx, pp: ji0(xx)) if ji0 else None
            hess_raw = (lambda xx, yy, zz, pp: h0(xx, yy, zz)) \
                if h0 else None
        self.f_raw = f_raw
        self.eq_raw, self.ineq_raw = eq_raw, ineq_raw
        self.m_e, self.m_i, self.n_x = m_e, m_i, n_x

        f = lambda xx, pp: pp["sf"] * f_raw(xx, pp["p"])  # noqa: E731
        c_e_fn = (lambda xx, pp: pp["ge"] * eq_raw(xx, pp["p"])) if m_e \
            else None
        c_i_fn = (lambda xx, pp: pp["gi"] * ineq_raw(xx, pp["p"])) \
            if m_i else None
        # analytic derivatives get the same row scaling as the constraints
        jac_e_fn = (lambda xx, pp: pp["ge"][:, None]
                    * je_raw(xx, pp["p"])) \
            if (m_e and je_raw is not None) else None
        jac_i_fn = (lambda xx, pp: pp["gi"][:, None]
                    * ji_raw(xx, pp["p"])) \
            if (m_i and ji_raw is not None) else None
        # hess convention: the user callable computes the RAW Lagrangian
        # Hessian  ∇²f_raw - Σ ŷ_i ∇²c_E,i - Σ ẑ_j ∇²c_I,j  with duals
        # mapped into raw-constraint space; the wrapper rescales the whole
        # thing by sf so it equals the Hessian of the scaled Lagrangian
        hess_fn = (lambda xx, yy, zz, pp: pp["sf"] * hess_raw(
            xx, (pp["ge"] * yy / pp["sf"]) if m_e else yy,
            (pp["gi"] * zz / pp["sf"]) if m_i else zz, pp["p"])) \
            if hess_raw is not None else None

        (self.step, self.step_f64, self.kkt_error, self.metrics,
         self.resto_step,
         (self.c_e, self.c_i, self.grad_f, self.jac_e, self.jac_i,
          self.kkt_components, self.kkt_error_multi, self.metrics_p,
          self.ls_probe)) = _make_fns(
            f, c_e_fn, c_i_fn, n_x, m_e, m_i,
            jac_e_fn=jac_e_fn, jac_i_fn=jac_i_fn, hess_fn=hess_fn,
            kkt_obj=problem.kkt)

        # jitted wrappers for every host-loop evaluation: an eager
        # constraint or Jacobian evaluation is hundreds of op-by-op
        # dispatches
        self.f_j = jax.jit(f)
        self.c_e_j = jax.jit(self.c_e)
        self.c_i_j = jax.jit(self.c_i)
        self.grad_f_j = jax.jit(self.grad_f)
        self.jac_e_j = jax.jit(self.jac_e)
        self.jac_i_j = jax.jit(self.jac_i)
        self.grad_f_jvp_j = jax.jit(lambda xx, dd, pp: jax.jvp(
            lambda xv: self.grad_f(xv, pp), (xx,), (dd,))[1])
        # gradient-based scaling inputs (RAW p, not the pk pytree)
        self.grad_max_j = jax.jit(lambda xx, pp: jnp.max(jnp.abs(
            jax.grad(f_raw)(xx, pp))))
        if problem.kkt is not None:
            self.kkt_row_maxes_j = jax.jit(problem.kkt.row_maxes)
        else:
            self.kkt_row_maxes_j = None
            self.row_max_e_j = self._row_max(eq_raw, je_raw) if m_e \
                else None
            self.row_max_i_j = self._row_max(ineq_raw, ji_raw) if m_i \
                else None

        c_e, c_i = self.c_e, self.c_i

        @jax.jit
        def theta_of_dev(xx, pp):
            t = jnp.asarray(0.0)
            if m_e:
                t += jnp.sum(jnp.abs(c_e(xx, pp)))
            if m_i:
                t += jnp.sum(jnp.abs(jnp.minimum(c_i(xx, pp), 0.0)))
            return t

        self.theta_of_dev = theta_of_dev

    def _row_max(self, fn_raw, jac_raw):
        """Jitted per-row max|J| at x0 for gradient-based scaling. The
        row-max reduction happens ON DEVICE (one small (m,) readback);
        large problems use the chunked tangent basis — an eager full
        jax.jacfwd here would materialize n_x copies of the constraint
        graph."""
        if jac_raw is not None:
            jac = jac_raw
        elif self.n_x > _CHUNK_THRESHOLD:
            jac = _chunked_jacfwd(fn_raw, self.n_x)
        else:
            jac = jax.jacfwd(fn_raw)
        return jax.jit(
            lambda xx, pp: jnp.max(jnp.abs(jac(xx, pp)), axis=1))


_ENGINES: "dict" = {}
_ENGINE_CAP = 8


def _get_engine(problem: NlpProblem, n_x: int, m_e: int, m_i: int):
    if problem.engine_key is None:
        return _Engine(problem, n_x, m_e, m_i)
    fns = (problem.objective, problem.eq, problem.ineq, problem.jac_eq,
           problem.jac_ineq, problem.hess, problem.kkt)
    key = (problem.engine_key, n_x, m_e, m_i)
    eng = _ENGINES.pop(key, None)
    # belt-and-braces: a key collision with DIFFERENT callables would
    # serve a foreign trace — rebuild instead
    if eng is not None and eng._key_fns != fns:
        eng = None
    if eng is None:
        eng = _Engine(problem, n_x, m_e, m_i)
        eng._key_fns = fns
    _ENGINES[key] = eng        # re-insert = most-recently-used
    while len(_ENGINES) > _ENGINE_CAP:
        _ENGINES.pop(next(iter(_ENGINES)))
    return eng


def solve_nlp(problem: NlpProblem, x0: np.ndarray,
              max_iter: int = 200, tol: float = 1e-8,
              acceptable_tol: float = 1e-6, acceptable_iter: int = 25,
              mu0: float = 0.1, verbose: int = 0,
              warm_duals: Optional[tuple] = None,
              max_seconds: Optional[float] = None) -> IpmResult:
    """Outer IPM driver (host loop over jitted steps).

    ``warm_duals`` is an optional ``(y, z, s)`` triple from a previous
    solve of the same-shaped problem (the reference's ``setdual``/
    ``transferdual!`` carry, optimalPowerFlow/utility.jl:417-691): the
    equality duals seed y directly and the inequality duals/slacks are
    projected into the central-path band for the starting barrier.

    ``max_seconds`` is a wall-clock budget (excluding the first compile):
    on expiry the loop stops and the best iterate is returned, flagged
    acceptable/failed by its KKT error — the benchmark guard rail.
    """
    import time as _time
    x = jnp.asarray(np.asarray(x0, dtype=np.float64))
    n_x = x.shape[0]
    p = problem.params if problem.params is not None else ()
    # row counts via eval_shape: NO device execution — an eager eq/ineq
    # evaluation here runs hundreds of op-by-op dispatches plus a
    # readback just to learn a static shape
    # NOTE the fresh lambdas: eval_shape on the bound method itself hits
    # JAX's internal callable-keyed cache, and a live-edited spec (same
    # method identity, mutated row lists) would report its STALE pre-edit
    # shape (the round-5 fix/unfix regression)
    if problem.params is not None:
        m_e = int(jax.eval_shape(
            lambda xx, pp: problem.eq(xx, pp), x, p).shape[0]) \
            if problem.eq else 0
        m_i = int(jax.eval_shape(
            lambda xx, pp: problem.ineq(xx, pp), x, p).shape[0]) \
            if problem.ineq else 0
    else:
        m_e = int(jax.eval_shape(lambda xx: problem.eq(xx), x).shape[0]) \
            if problem.eq else 0
        m_i = int(jax.eval_shape(
            lambda xx: problem.ineq(xx), x).shape[0]) \
            if problem.ineq else 0

    # every traced/jitted function, cached across solves of the same
    # problem structure (see _Engine)
    eng = _get_engine(problem, n_x, m_e, m_i)
    step, step_f64 = eng.step, eng.step_f64
    kkt_error, metrics, resto_step = (eng.kkt_error, eng.metrics,
                                      eng.resto_step)
    kkt_error_multi, metrics_p, ls_probe = (eng.kkt_error_multi,
                                            eng.metrics_p, eng.ls_probe)
    kkt_components = eng.kkt_components
    f_j, c_e_j, c_i_j = eng.f_j, eng.c_e_j, eng.c_i_j
    grad_f_j, jac_e_j, jac_i_j = eng.grad_f_j, eng.jac_e_j, eng.jac_i_j
    grad_f_jvp_j = eng.grad_f_jvp_j

    # Ipopt-style gradient-based scaling (their nlp_scaling_method =
    # "gradient-based"): keep max|∇f| near 100 so currency-unit cost
    # coefficients don't swamp the KKT tolerances, and scale every
    # constraint row the same way — epigraph cuts and balance rows with
    # cost-unit coefficients otherwise leave the dual residual O(1e4) and
    # the barrier parameter permanently gated.
    gmax = float(eng.grad_max_j(x, p)) if n_x else 1.0
    scale_f = min(1.0, 100.0 / gmax) if gmax > 0 else 1.0

    g_e = g_i = None
    if problem.kkt is not None and (m_e or m_i):
        # structured path: per-row maxima from the same closed forms the
        # BBD assembly uses — no dense (m, n_x) Jacobian at 10k+ scale
        rme_d, rmi_d = eng.kkt_row_maxes_j(x, p)
        if m_e:
            row = np.asarray(rme_d)
            g_e = jnp.asarray(
                np.minimum(1.0, 100.0 / np.maximum(row, 1e-12)))
        if m_i:
            row = np.asarray(rmi_d)
            g_i = jnp.asarray(
                np.minimum(1.0, 100.0 / np.maximum(row, 1e-12)))
    else:
        if m_e:
            row = np.asarray(eng.row_max_e_j(x, p))
            g_e = jnp.asarray(
                np.minimum(1.0, 100.0 / np.maximum(row, 1e-12)))
        if m_i:
            row = np.asarray(eng.row_max_i_j(x, p))
            g_i = jnp.asarray(
                np.minimum(1.0, 100.0 / np.maximum(row, 1e-12)))

    # the scale factors ride the params pytree (not the trace) so an
    # edited model re-solves against the same compiled step functions
    pk = {"p": p, "sf": jnp.asarray(scale_f)}
    if g_e is not None:
        pk["ge"] = g_e
    if g_i is not None:
        pk["gi"] = g_i

    # once the f32 precision wall is detected (failed linear residual at
    # the endgame), every later Newton system solves through the f64
    # LU — active-set conditioning only worsens as mu shrinks
    use_f64 = False
    # the restoration LM and the dual-recovery polish both materialize
    # dense (m, n_x)/(n_x, n_x) intermediates — fine to pegase scale,
    # structurally OOM at 10k+. The structured-KKT path survives without
    # them (returns the best iterate instead); these caps gate the dense
    # fallbacks, they do not change behavior below them.
    resto_ok = n_x <= 8192
    recovery_ok = n_x <= 4096

    # start-with-restoration (Ipopt's start_with_resto): a badly infeasible
    # start (MATPOWER setpoints can violate balance by tens of p.u.) pins
    # the barrier iteration — slacks at the boundary cap every step via
    # fraction-to-boundary while duals blow up. A cheap Levenberg-Marquardt
    # pass on the violation first makes the barrier loop start near-feasible.
    def _theta_of(xx):
        return float(eng.theta_of_dev(xx, pk))

    theta_start = _theta_of(x)
    if (m_e or m_i) and theta_start > 1.0 and resto_ok:
        lam = 1e-6
        th = theta_start
        for _ in range(60):
            dxr, _ = resto_step(x, lam, pk)
            if not bool(jnp.all(jnp.isfinite(dxr))):
                lam *= 10.0
                continue
            x_try = x + dxr
            th_try = _theta_of(x_try)
            if th_try < th:
                x, th = x_try, th_try
                lam = max(lam / 3.0, 1e-10)
                if th < 1e-6 * max(1.0, theta_start):
                    break
            else:
                lam *= 10.0
                if lam > 1e12:
                    break
        if verbose >= 1:
            print(f"  ipm start-with-resto: theta {theta_start:.3e} "
                  f"-> {th:.3e}")
        if problem.push_inside is not None:
            # re-box: restoration trades a hair of bound violation for
            # balance feasibility; push the iterate strictly back inside
            # its simple bounds so the slacks start at healthy magnitudes
            x_np = np.array(x)
            out = problem.push_inside(x_np)
            x = jnp.asarray(out if out is not None else x_np)

    if m_i:
        ci0 = c_i_j(x, pk)
        # floor the initial slacks at 0.01 (Ipopt's slack push): the
        # |c_I - s| = 0.01 this manufactures on near-active rows is
        # LINEAR residual the very first full Newton step can correct,
        # and healthy slack magnitudes keep fraction-to-boundary steps
        # usable. (Round-4 note: a near-zero floor was tried for the
        # 118-bus linear-cost DC OPF and it traded this for pinned
        # 1e-6-scale slacks, which is strictly worse; the actual fix for
        # that case was judging the boundary pinch CUMULATIVELY — see
        # pinch detection below.)
        s = jnp.maximum(ci0, 1e-2)
        z = jnp.clip(mu0 / s, 1e-8, 1e6)
    else:
        s = jnp.zeros(0)
        z = jnp.zeros(0)
    y = jnp.zeros(m_e)

    if warm_duals is not None:
        y_w, z_w, s_w = warm_duals
        # the carried duals are unscaled (IpmResult form); map them into
        # this solve's scaled space, then project z into the central-path
        # band so a stale dual can't pin the first fraction-to-boundary
        if m_e and y_w is not None and len(y_w) == m_e:
            y = jnp.asarray(np.asarray(y_w, dtype=np.float64)) * scale_f
            if g_e is not None:
                y = y / g_e
        if m_i and s_w is not None and len(s_w) == m_i:
            # carried slacks too: re-flooring them at the cold-start push
            # (0.01) manufactures |c_I - s| ~ 0.01 PER ROW of violation
            # on a warm iterate that was feasible to machine precision
            s_c = jnp.asarray(np.asarray(s_w, dtype=np.float64))
            if g_i is not None:
                s_c = s_c * g_i    # IpmResult reports s / g_i
            s = jnp.maximum(s_c, 1e-300)
        if m_i and z_w is not None and len(z_w) == m_i:
            z_c = jnp.asarray(np.asarray(z_w, dtype=np.float64)) * scale_f
            if g_i is not None:
                z_c = z_c / g_i
            z = jnp.clip(z_c, mu0 / (KAPPA_SIGMA * s), KAPPA_SIGMA * mu0 / s)
            z = jnp.maximum(z, 1e-14)

    mu = mu0
    mu_min = tol / 11.0
    converged = False
    it = 0
    err = np.inf
    best = None
    stall = 0
    # most-FEASIBLE iterate seen, tracked separately from best-KKT: at a
    # degenerate endgame the duals thrash (huge KKT error) while the
    # primal converges to machine precision — dual recovery needs the
    # feasible iterate, not the best-KKT one (round-4/5 pegase: best-KKT
    # theta 6e-5 failed the recovery gate while the last iterates sat at
    # theta 1e-9 with the exact optimum objective)
    best_feas = None
    best_feas_theta = np.inf

    _, theta0, _, _, _ = metrics(x, s, mu, pk)
    theta0 = float(theta0)
    prev_obj = None
    acceptable_run = 0
    theta_min = 1e-4 * max(1.0, theta0)
    theta_max = 1e4 * max(1.0, theta0)
    # the filter starts with the theta cap (W-B eq. 25)
    filt = [(theta_max, -np.inf)]
    delta_last = 0.0
    pinched = 0
    pinch_theta0 = np.inf
    t_start = None  # armed after the first (compile-bearing) iteration

    def _dual_recovery_corr(x_r, y_r, z_r, s_in):
        """Correction fit: KEEP the seed duals and lstsq only the
        correction on (y, strongly-active z). At a degenerate endgame the
        near-converged z spreads real multiplier mass across a long tail
        of weakly-active rows — rebuilding it from scratch plateaus
        (round-5 pegase: 0.16 at every threshold) while a small
        correction on top of the seed lands at refinement level (6.7e-6
        -> 5.4e-8 measured offline). One lstsq per strength cut."""
        try:
            xj = jnp.asarray(np.asarray(x_r, dtype=np.float64))
            g_np = np.asarray(grad_f_j(xj, pk))
            je_np = np.asarray(jac_e_j(xj, pk)) if m_e \
                else np.zeros((0, n_x))
            ji_np = np.asarray(jac_i_j(xj, pk)) if m_i \
                else np.zeros((0, n_x))
            ci_np = np.asarray(c_i_j(xj, pk)) if m_i else np.zeros(0)
            y_np = np.asarray(y_r, dtype=np.float64)
            z_np = np.asarray(z_r, dtype=np.float64) if m_i \
                else np.zeros(0)
            s_r = jnp.maximum(jnp.asarray(ci_np), 1e-12) if m_i else s_in
            best_loc = None
            zmax = float(z_np.max()) if z_np.size else 0.0
            for frac in (1e-3, 1e-4, 1e-5):
                strong = z_np > frac * zmax if zmax > 0 else \
                    np.zeros(m_i, dtype=bool)
                cols = [je_np]
                if strong.any():
                    cols.append(ji_np[strong])
                a_mat = np.vstack(cols).T
                r = g_np - je_np.T @ y_np - ji_np.T @ z_np
                corr, *_ = np.linalg.lstsq(a_mat, r, rcond=None)
                y2 = y_np + corr[:m_e]
                z2 = z_np.copy()
                if strong.any():
                    z2[strong] = np.maximum(
                        z2[strong] + corr[m_e:], 0.0)
                err_r = float(kkt_error(
                    xj, jnp.asarray(y2), jnp.asarray(z2), s_r, 0.0, pk))
                if verbose >= 2:
                    print(f"      dual-corr frac={frac:.0e} "
                          f"strong={int(strong.sum())} -> err "
                          f"{err_r:.2e}")
                if best_loc is None or err_r < best_loc[0]:
                    best_loc = (err_r, xj, jnp.asarray(y2),
                                jnp.asarray(z2), s_r)
                if err_r < tol:
                    break
            return best_loc
        except Exception as exc:
            if verbose >= 2:
                print(f"      dual-corr exception: {exc!r}")
            return None

    def _dual_recovery(x_r, s_in, err_now, y_seed=None, z_seed=None):
        """Degenerate active sets (LP vertices, piecewise breakpoints)
        leave the primal converged while the Newton duals thrash on a
        non-unique multiplier set. Polish the primal onto the active
        manifold (host-side Gauss-Newton on [c_E; c_A] = 0), then solve
        the tiny NNLS for the multipliers directly:
        min ||g - J_E'y - J_A'z_A||, z_A >= 0 over the active
        inequalities — the dual problem at the known solution.
        Returns (err, x, y, z, s) on improvement, else None."""
        best_rec = None
        if y_seed is not None and (m_e or m_i):
            best_rec = _dual_recovery_corr(x_r, y_seed, z_seed, s_in)
            # early out when the cheap correction already lands: always
            # at the strict tolerance; at the acceptable level too on
            # large problems, where the fit-first sweep costs ~10 host
            # minutes of (m, n_x) lstsq passes (pegase measurement)
            if best_rec is not None and (
                    best_rec[0] < tol
                    or (n_x > 2048 and best_rec[0] < acceptable_tol)):
                return best_rec if best_rec[0] < err_now else None
        # fit-first sweep: generous candidate thresholds — the round-5
        # pegase diagnosis showed the true active rows sitting at
        # ci ~ 1e-3 * scale from a theta-1e-5-grade iterate, far outside
        # the tight thresholds, while the stationarity FIT identifies
        # them exactly (lstsq residual 1e-7 at thr=1e-3)
        for thr in (1e-5, 1e-4, 1e-3, 1e-2):
            rec = _dual_recovery_at(x_r, s_in, thr)
            if rec is not None and (best_rec is None
                                    or rec[0] < best_rec[0]):
                best_rec = rec
                if best_rec[0] < tol:
                    break
        if (best_rec is None or best_rec[0] >= tol) \
                and n_x <= 2048:
            # small-problem fallback: the polish-first + simplex-style
            # crossover walk (handles epsilon-degenerate LP edges)
            for thr in (1e-5, 1e-4, 1e-6, 1e-3):
                rec = _dual_recovery_crossover(x_r, s_in, thr)
                if rec is not None and (best_rec is None
                                        or rec[0] < best_rec[0]):
                    best_rec = rec
                    if best_rec[0] < tol:
                        break
        if best_rec is not None and best_rec[0] < err_now:
            return best_rec
        return None

    def _dual_recovery_at(x_r, s_in, thr):
        """Fit-first recovery: NNLS multipliers at the UNPOLISHED iterate
        over a generous candidate set (ci <= thr * scale), then polish
        the primal only onto the multiplier SUPPORT and refit. Polishing
        a raw threshold set first (the pre-round-5 order) moves x off
        the optimum whenever the threshold over-includes near-active
        rows — the polished-manifold residual blows up and the fit
        fails; identifying the support from the stationarity fit makes
        the polish target exactly the rows the optimum pins."""
        try:
            x_np = np.asarray(x_r, dtype=np.float64)
            if m_i:
                ci0 = np.asarray(c_i_j(x_r, pk))
                scale_ci = max(1.0, float(np.max(np.abs(ci0))))
                act = ci0 <= thr * scale_ci
            else:
                act = np.zeros(0, dtype=bool)
            f_old = float(f_j(jnp.asarray(x_np), pk))

            def polish(x_np, act_p):
                for _ in range(3):
                    xj = jnp.asarray(x_np)
                    parts_r, parts_j = [], []
                    if m_e:
                        parts_r.append(np.asarray(c_e_j(xj, pk)))
                        parts_j.append(np.asarray(jac_e_j(xj, pk)))
                    if m_i and act_p.any():
                        parts_r.append(np.asarray(c_i_j(xj, pk))[act_p])
                        parts_j.append(np.asarray(jac_i_j(xj, pk))[act_p])
                    if not parts_r:
                        return x_np
                    r_all = np.concatenate(parts_r)
                    if float(np.max(np.abs(r_all))) < 1e-13:
                        return x_np
                    j_all = np.vstack(parts_j)
                    dx_p, *_ = np.linalg.lstsq(j_all, -r_all, rcond=None)
                    if float(np.max(np.abs(dx_p))) > 1.0:
                        return x_np
                    x_np = x_np + dx_p
                return x_np

            def nnls(g_np, je_np, ji_np, cand):
                act_try = cand.copy()
                sol = np.zeros(m_e)
                for _ in range(12):
                    a_mat = np.vstack([je_np, ji_np[act_try]]).T
                    sol, *_ = np.linalg.lstsq(a_mat, g_np, rcond=None)
                    neg = sol[m_e:] < -1e-10
                    if not neg.any():
                        break
                    idxs = np.flatnonzero(act_try)
                    act_try[idxs[neg]] = False
                else:
                    # exhausted with a prune on the last pass: realign
                    a_mat = np.vstack([je_np, ji_np[act_try]]).T
                    sol, *_ = np.linalg.lstsq(a_mat, g_np, rcond=None)
                return sol, act_try

            best_loc = None
            for fit_pass in range(2):
                xj = jnp.asarray(x_np)
                g_np = np.asarray(grad_f_j(xj, pk))
                je_np = np.asarray(jac_e_j(xj, pk)) if m_e \
                    else np.zeros((0, n_x))
                if m_i:
                    ci_np = np.asarray(c_i_j(xj, pk))
                    ji_np = np.asarray(jac_i_j(xj, pk))
                    if bool(np.any(ci_np < -1e-9)):
                        break  # polish left feasibility; keep previous
                else:
                    ci_np = np.zeros(0)
                    ji_np = np.zeros((0, n_x))
                if float(f_j(xj, pk)) > f_old \
                        + 1e-6 * max(1.0, abs(f_old)):
                    break  # objective worsened; not a polish any more
                sol, act_try = nnls(g_np, je_np, ji_np, act)
                y_r = jnp.asarray(sol[:m_e])
                z_np = np.zeros(m_i)
                if m_i:
                    z_np[act_try] = np.maximum(sol[m_e:], 0.0)
                z_r = jnp.asarray(z_np)
                s_r = jnp.maximum(jnp.asarray(ci_np), 1e-12) if m_i \
                    else s_in
                err_r = float(kkt_error(xj, y_r, z_r, s_r, 0.0, pk))
                if verbose >= 2:
                    print(f"      dual-recovery thr={thr:.0e} "
                          f"fit={fit_pass}: act={int(act_try.sum())} "
                          f"-> err {err_r:.2e}")
                if best_loc is None or err_r < best_loc[0]:
                    best_loc = (err_r, xj, y_r, z_r, s_r)
                if err_r < tol or not m_i:
                    break
                # polish onto the multiplier support, refit once
                zmax = float(z_np.max()) if m_i else 0.0
                supp = act_try & (z_np > 1e-8 * max(1.0, zmax))
                if not supp.any() or fit_pass == 1:
                    break
                x_np = polish(x_np, supp)
                act = supp
            return best_loc
        except Exception as exc:
            if verbose >= 2:
                import traceback
                print(f"      dual-recovery exception: {exc!r}")
                traceback.print_exc()
            return None  # best-effort: keep the iterate

    def _dual_recovery_crossover(x_r, s_in, thr):
        """Polish-first recovery + simplex-style crossover: descend along
        the active manifold's null space until a new inequality blocks,
        adopt it, repeat. Handles epsilon-degenerate optimal edges where
        the IPM iterate sits a visible distance from the vertex that
        carries the multipliers (small-scale fallback; the fit-first
        _dual_recovery_at is the primary path)."""
        try:
            x_np = np.asarray(x_r, dtype=np.float64)
            if m_i:
                ci0 = np.asarray(c_i_j(x_r, pk))
                scale_ci = max(1.0, float(np.max(np.abs(ci0))))
                act = ci0 <= thr * scale_ci
            else:
                act = np.zeros(0, dtype=bool)
            f_old = float(f_j(jnp.asarray(x_np), pk))

            def polish(x_np, act):
                for _ in range(3):
                    xj = jnp.asarray(x_np)
                    parts_r, parts_j = [], []
                    if m_e:
                        parts_r.append(np.asarray(c_e_j(xj, pk)))
                        parts_j.append(np.asarray(jac_e_j(xj, pk)))
                    if m_i and act.any():
                        parts_r.append(np.asarray(c_i_j(xj, pk))[act])
                        parts_j.append(np.asarray(jac_i_j(xj, pk))[act])
                    if not parts_r:
                        return x_np
                    r_all = np.concatenate(parts_r)
                    if float(np.max(np.abs(r_all))) < 1e-13:
                        return x_np
                    j_all = np.vstack(parts_j)
                    dx, *_ = np.linalg.lstsq(j_all, -r_all, rcond=None)
                    if float(np.max(np.abs(dx))) > 1.0:
                        return x_np
                    x_np = x_np + dx
                return x_np

            x_np = polish(x_np, act)
            best_loc = None
            for cross in range(8):
                xj = jnp.asarray(x_np)
                g_np = np.asarray(grad_f_j(xj, pk))
                je_np = np.asarray(jac_e_j(xj, pk)) if m_e \
                    else np.zeros((0, n_x))
                if m_i:
                    ci_np = np.asarray(c_i_j(xj, pk))
                    ji_np = np.asarray(jac_i_j(xj, pk))
                    if bool(np.any(ci_np < -1e-9)):
                        if verbose >= 3:
                            print(f"        crossover: infeasible "
                                  f"{float(np.min(ci_np)):.2e}")
                        break  # infeasible point; keep previous best
                else:
                    ci_np = np.zeros(0)
                    ji_np = np.zeros((0, n_x))
                if float(f_j(xj, pk)) > f_old + 1e-6 * max(1.0, abs(f_old)):
                    if verbose >= 3:
                        print(f"        crossover: f worsened "
                              f"{float(f_j(xj, pk)) - f_old:.2e}")
                    break  # objective worsened; not a polish any more
                # NNLS multipliers on the current active set
                act_try = act.copy()
                sol = np.zeros(m_e)
                for _ in range(12):
                    a_mat = np.vstack([je_np, ji_np[act_try]]).T
                    sol, *_ = np.linalg.lstsq(a_mat, g_np, rcond=None)
                    neg = sol[m_e:] < -1e-10
                    if not neg.any():
                        break
                    idxs = np.flatnonzero(act_try)
                    act_try[idxs[neg]] = False
                else:
                    # exhausted with a prune on the last pass: sol is
                    # sized for the PRE-prune set — recompute once so
                    # the multiplier scatter below stays aligned (this
                    # crashed the first pegase recovery attempt)
                    a_mat = np.vstack([je_np, ji_np[act_try]]).T
                    sol, *_ = np.linalg.lstsq(a_mat, g_np, rcond=None)
                y_r = jnp.asarray(sol[:m_e])
                z_np = np.zeros(m_i)
                if m_i:
                    z_np[act_try] = np.maximum(sol[m_e:], 0.0)
                z_r = jnp.asarray(z_np)
                s_r = jnp.maximum(jnp.asarray(ci_np), 1e-12) if m_i \
                    else s_in
                err_r = float(kkt_error(xj, y_r, z_r, s_r, 0.0, pk))
                if verbose >= 2:
                    print(f"      dual-recovery thr={thr:.0e} "
                          f"pass={cross}: act={int(act_try.sum())} "
                          f"-> err {err_r:.2e}")
                if best_loc is None or err_r < best_loc[0]:
                    best_loc = (err_r, xj, y_r, z_r, s_r)
                if err_r < tol or not m_i:
                    break
                # crossover: null-space descent until a new row blocks.
                # Project via the SVD row-space basis — pinv(A) @ (A @ g)
                # amplifies rounding by cond(A), and A is near-rank-
                # deficient at exactly the degenerate vertices this
                # handles.
                a_rows = np.vstack([je_np, ji_np[act]])
                if a_rows.size:
                    sv_u, sv_s, sv_vt = np.linalg.svd(
                        a_rows, full_matrices=False)
                    keep = sv_s > (sv_s[0] * 1e-10 if sv_s.size else 0.0)
                    vr = sv_vt[keep]
                    d = -(g_np - vr.T @ (vr @ g_np))
                else:
                    d = -g_np
                d_norm = float(np.linalg.norm(d))
                if verbose >= 3:
                    print(f"        crossover |d|={d_norm:.2e}")
                if d_norm < 1e-12 * max(1.0, float(np.linalg.norm(g_np))):
                    break
                d = d / d_norm  # unit step so the ratio test is geometric
                # exact line search on the local quadratic model: the
                # objective can be quadratic (cost curves), so the walk
                # must stop at the along-face minimum, not just at the
                # first blocking row
                # exact by construction: d = -(I-P)g, so after unit
                # normalization the slope is -|d|. (The dot product g.d
                # is numerically useless here: d carries ~eps*|g| rounding
                # from the projection subtraction, and dividing by the
                # tiny |d| amplifies it orders above the true slope.)
                f_slope = -d_norm
                hvp = np.asarray(grad_f_jvp_j(xj, jnp.asarray(d), pk))
                curv = float(d @ hvp)
                t_star = -f_slope / curv if curv > 1e-12 else np.inf
                inact = np.flatnonzero(~act)
                slope = ji_np[~act] @ d
                blocking = slope < -1e-12
                t_block = np.inf
                j_block = -1
                if blocking.any():
                    ts = ci_np[~act][blocking] / (-slope[blocking])
                    t_block = float(np.min(ts))
                    j_block = inact[np.flatnonzero(blocking)[
                        int(np.argmin(ts))]]
                t_step = min(t_star, t_block)
                if verbose >= 3:
                    print(f"        crossover t={t_step:.3e} "
                          f"(t*={t_star:.3e} t_block={t_block:.3e} "
                          f"slope={f_slope:.3e} curv={curv:.3e})")
                if not np.isfinite(t_step) or t_step > 1e3 \
                        or t_step <= 0.0:
                    break
                x_np = x_np + t_step * d
                if t_block <= t_star and j_block >= 0:
                    act[j_block] = True
                x_np = polish(x_np, act)
            return best_loc
        except Exception as exc:
            if verbose >= 2:
                import traceback
                print(f"      dual-recovery exception: {exc!r}")
                traceback.print_exc()
            return None  # best-effort: keep the iterate

    for it in range(1, max_iter + 1):
        if max_seconds is not None:
            if t_start is None and it == 2:
                t_start = _time.perf_counter()
            elif t_start is not None and \
                    _time.perf_counter() - t_start > max_seconds:
                break
        # E at mu=0 (the stopping error) AND at the whole deterministic
        # Fiacco-McCormick mu ladder, in one device call / one readback —
        # per-candidate kkt_error dispatches are a measurable share of a
        # small problem's wall
        mu_ladder = [mu]
        while mu_ladder[-1] > mu_min:
            mc = mu_ladder[-1]
            # superlinear decrease, CAPPED at 50x per rung on LARGE
            # problems: the raw mu^1.5 rule jumps 1.8e-6 -> 2.5e-9 in
            # one step near convergence, and recentring z three decades
            # at once is what thrashed the round-5 pegase endgame (every
            # s*z product sat at the OLD mu while the new mu demanded
            # huge dz). The ladder walk still descends MULTIPLE rungs
            # per iteration whenever E_mu allows. Small problems keep
            # the classic jump — their Newton steps absorb the
            # recentring in one go and the jump reaches optimal-grade
            # error faster than the capped path.
            cap = mc / 50.0 if n_x > 1024 else 0.0
            mu_ladder.append(max(mu_min, cap,
                                 min(KAPPA_MU * mc, mc ** THETA_MU)))
        errs = np.asarray(kkt_error_multi(
            x, y, z, s, jnp.asarray([0.0] + mu_ladder), pk))
        err = float(errs[0])
        if best is None or err < best[0]:
            best = (err, x, y, z, s)
            stall = 0
        else:
            stall += 1
        if err < tol:
            converged = True
            break
        # Ipopt-style acceptable-level stop: degenerate active sets (e.g.
        # an optimum exactly at a piecewise-cost breakpoint) leave the KKT
        # system singular in the limit; accept the best iterate once
        # progress stalls below the acceptable tolerance.
        if stall >= acceptable_iter and best[0] < acceptable_tol:
            converged = True
            break
        # degenerate endgame: the barrier is at its floor, the best iterate
        # is already acceptable, and the last step blew the error up by
        # orders of magnitude — further Newton steps on the near-singular
        # KKT system only thrash; return the best iterate now
        if mu <= mu_min * 1.01 and best[0] < acceptable_tol and \
                err > 10.0 * best[0]:
            converged = True
            break

        # monotone Fiacco-McCormick with superlinear decrease, gated on
        # the mu-scaled error (W-B eq. 7); the filter resets on mu change
        changed = False
        i_mu = 0
        while mu_ladder[i_mu] > mu_min and \
                float(errs[1 + i_mu]) <= KAPPA_EPS * mu_ladder[i_mu]:
            i_mu += 1
            changed = True
        mu = mu_ladder[i_mu]
        if changed:
            filt = [(theta_max, -np.inf)]

        mstats, ce_k, ri_k = metrics_p(x, s, mu, pk)
        mst = np.asarray(mstats)
        fval, theta_k, phi_k, max_ri = (float(mst[0]), float(mst[1]),
                                        float(mst[2]), float(mst[3]))
        if theta_k < best_feas_theta:
            best_feas = (x, y, z, s)
            best_feas_theta = theta_k
        # mu near its floor (it can stall an order above mu_min when the
        # thrashing dual residual keeps E_mu > kappa*mu), KKT stalled,
        # primal (near-)feasible: the duals are thrashing on a degenerate
        # active set — recover multipliers directly instead of burning
        # the iteration budget (tried every 16 stalled iterations; the
        # NNLS polish is host-side expensive)
        if mu <= max(mu_min * 1.01, 100.0 * tol) and recovery_ok \
                and theta_k <= 1e-5 \
                and stall >= 8 and (stall - 8) % 16 == 0:
            # cheap first: best-KKT duals on the most-feasible primal
            if best is not None and best_feas is not None:
                err_cross = float(kkt_error(
                    best_feas[0], best[2], best[3], best_feas[3],
                    0.0, pk))
                if err_cross < best[0]:
                    best = (err_cross, best_feas[0], best[2], best[3],
                            best_feas[3])
                    if verbose >= 1:
                        print(f"  ipm iter {it}: cross candidate "
                              f"kkt -> {err_cross:.3e}")
                    if err_cross < acceptable_tol:
                        err, x, y, z, s = best
                        converged = err < tol
                        break
            # recover from the BEST iterate's primal (the current x is
            # the one that just thrashed; run-5 chip logs: corr from the
            # thrashed x gave 4.4e-4 where the same seed on the best
            # primal gave 3.0e-7)
            rec = _dual_recovery(best[1], best[4], err,
                                 y_seed=best[2], z_seed=best[3])
            if rec is not None and rec[0] < best[0]:
                best = rec
                if verbose >= 1:
                    print(f"  ipm iter {it}: mid-loop dual recovery "
                          f"kkt -> {rec[0]:.3e}")
                if rec[0] < acceptable_tol:
                    err, x, y, z, s = rec
                    converged = err < tol
                    break

        # Ipopt acceptable-point heuristic (their acceptable_iter /
        # acceptable_constr_viol_tol / acceptable_obj_change_tol): a
        # degenerate active set (e.g. the optimum exactly at a piecewise
        # breakpoint, or a just-relaxed binding row) leaves the KKT system
        # singular in the limit — the dual residual oscillates while the
        # iterate is, for every practical purpose, the solution. Stop once
        # the violation is negligible and the objective has been stagnant
        # for `acceptable_iter` consecutive iterations.
        fv = fval
        if theta_k <= max(10.0 * tol, 1e-7) and \
                prev_obj is not None and \
                abs(fv - prev_obj) <= 1e-7 * max(1.0, abs(fv)):
            acceptable_run += 1
            if acceptable_run >= acceptable_iter:
                if best is not None and best[0] < acceptable_tol:
                    converged = True
                    break
                # primal stagnant but duals thrashing (degenerate vertex):
                # recover multipliers directly instead of iterating on
                rec = _dual_recovery(
                    x, s, err,
                    y_seed=best[2] if best is not None else y,
                    z_seed=best[3] if best is not None else z) \
                    if recovery_ok else None
                if rec is not None and rec[0] < acceptable_tol:
                    err, x, y, z, s = rec
                    best = (err, x, y, z, s)
                    converged = True
                    if verbose >= 1:
                        print(f"  ipm dual recovery: kkt -> {err:.3e}")
                    break
                acceptable_run = 0  # recovery failed; keep iterating
        else:
            acceptable_run = 0
        prev_obj = fv

        if m_i and max_ri > 0.0:
            # slack lifting: raising s_i to c_I(x)_i wherever c_I(x)_i > s_i
            # strictly reduces both theta (|c_I - s| -> 0) and phi
            # (-mu log s shrinks) — monotone for the filter, and it frees
            # fraction-to-boundary steps otherwise pinned by stale slacks
            s = jnp.where(ri_k > 0.0, s + ri_k, s)
            z = jnp.clip(z, mu / (KAPPA_SIGMA * s), KAPPA_SIGMA * mu / s)
            z = jnp.maximum(z, 1e-14)
            mstats, ce_k, ri_k = metrics_p(x, s, mu, pk)
            mst = np.asarray(mstats)
            theta_k, phi_k = float(mst[1]), float(mst[2])
        if verbose >= 2:
            print(f"  ipm iter {it}: kkt={err:.3e} mu={mu:.3e} "
                  f"theta={theta_k:.3e} phi={phi_k:.6e}")
            if verbose >= 3 or it % 10 == 0:
                du, drow, pr, co, crow = kkt_components(x, y, z, s, 0.0, pk)
                print(f"      kkt split: dual={float(du):.3e}"
                      f"@x[{int(drow)}] prim={float(pr):.3e} "
                      f"comp={float(co):.3e}@row[{int(crow)}]")

        # --- search direction with inertia-free delta escalation ---------
        delta = 0.0 if delta_last == 0.0 else max(1e-20, delta_last / 3.0)
        ok = False
        for attempt in range(30):
            cur_step = step_f64 if (use_f64 and step_f64 is not None) \
                else step
            dx, dy, ds, dz, sstats = cur_step(
                x, y, z, s, mu, delta, ce_k, ri_k, pk)
            # one readback for every scalar the host logic needs
            (alpha_s, alpha_z, lin_res, curv, dphi, dxn,
             finite) = (float(v) for v in np.asarray(sstats))
            ok = finite > 0.5 and lin_res < 1e-6 \
                and (curv >= 1e-12 * dxn or dxn == 0.0)
            if ok:
                break
            if not use_f64 and step_f64 is not None \
                    and finite > 0.5 and lin_res >= 1e-6:
                # finite step but the linear residual check failed: the
                # f32 factorization hit its precision wall (endgame
                # active-set conditioning), NOT an inertia problem —
                # switch to the full-f64 LU for the rest of the
                # solve and retry at the same delta
                use_f64 = True
                if verbose >= 1:
                    print(f"  ipm iter {it}: f32 lin_res "
                          f"{lin_res:.1e} -> f64 LU endgame")
                continue
            delta = 1e-8 * max(1.0, float(jnp.max(jnp.abs(x)))) \
                if delta == 0.0 else delta * 8.0
        delta_last = delta
        if not ok:
            break  # no factorizable system; return best iterate

        alpha_max = alpha_s

        # minimum trial step before feasibility restoration (W-B eq. 23)
        if dphi < 0.0:
            cands = [GAMMA_THETA]
            if theta_k > 0:
                cands.append(GAMMA_PHI * theta_k / (-dphi))
            if theta_k <= theta_min:
                cands.append(DELTA_SW * theta_k ** S_THETA
                             / (-dphi) ** S_PHI)
            alpha_min = GAMMA_ALPHA * min(cands)
        else:
            alpha_min = GAMMA_ALPHA * GAMMA_THETA
        alpha_min = min(alpha_min, alpha_max)

        # --- filter backtracking line search ------------------------------
        alpha = alpha_max
        accepted = False
        f_type = False
        soc_done = 0
        dx_t, ds_t = dx, ds
        theta_t = np.inf

        def _accept(th_t, ph_t, a):
            """Filter + switching/Armijo acceptance at one trial point."""
            if not (np.isfinite(th_t) and np.isfinite(ph_t)):
                return False, False
            if not _filter_accepts(filt, th_t, ph_t):
                return False, False
            switching = dphi < 0.0 and \
                a * (-dphi) ** S_PHI > DELTA_SW * theta_k ** S_THETA
            if theta_k <= theta_min and switching:
                return ph_t <= phi_k + ETA_PHI * a * dphi, True
            return (th_t <= (1.0 - GAMMA_THETA) * theta_k or
                    ph_t <= phi_k - GAMMA_PHI * theta_k), False

        # full-step phase: trial + second-order corrections (W-B §2.4) —
        # each SOC changes the DIRECTION so it needs its own step solve
        while True:
            x_t = x + alpha * dx_t
            s_t = jnp.maximum(s + alpha * ds_t, 1e-300) if m_i else s
            tstats, ce_t, ri_t = metrics_p(x_t, s_t, mu, pk)
            tst = np.asarray(tstats)
            theta_t, phi_t = float(tst[1]), float(tst[2])
            accepted, f_type = _accept(theta_t, phi_t, alpha)
            if accepted:
                break
            if alpha == alpha_max and soc_done < MAX_SOC and m_e + m_i and \
                    np.isfinite(theta_t) and theta_t >= theta_k:
                ce_soc = alpha * ce_k + ce_t if m_e else ce_k
                ri_soc = alpha * ri_k + ri_t if m_i else ri_k
                dx_c, _, ds_c, _, st_c = cur_step(
                    x, y, z, s, mu, delta, ce_soc, ri_soc, pk)
                st_c = np.asarray(st_c)
                if float(st_c[6]) > 0.5 and float(st_c[2]) < 1e-6:
                    soc_done += 1
                    dx_t, ds_t = dx_c, ds_c
                    alpha = alpha_max = min(alpha_max, float(st_c[0]))
                    continue
                soc_done = MAX_SOC
            if soc_done and (dx_t is not dx):
                # SOC trial failed: fall back to the uncorrected direction
                dx_t, ds_t = dx, ds
                alpha = alpha_max = alpha_s
                soc_done = MAX_SOC
                continue
            break

        if not accepted and alpha * 0.5 >= alpha_min:
            # backtracking phase: the direction is now fixed, so every
            # remaining trial point is probed in ONE device call and the
            # filter logic walks the (theta, phi) results host-side —
            # per-trial metrics dispatches would dominate deep
            # backtracks
            n_bt = min(60, int(np.floor(np.log2(
                max(alpha / max(alpha_min, 1e-300), 2.0)))) + 1)
            alphas = alpha * 0.5 ** np.arange(1, n_bt + 1)
            alphas = alphas[alphas >= alpha_min]
            if len(alphas):
                th_arr, ph_arr = ls_probe(
                    x, s, mu, dx_t, ds_t, jnp.asarray(alphas), pk)
                th_arr = np.asarray(th_arr)
                ph_arr = np.asarray(ph_arr)
                for a_c, th_c, ph_c in zip(alphas, th_arr, ph_arr):
                    acc, ft = _accept(float(th_c), float(ph_c),
                                      float(a_c))
                    if acc:
                        accepted, f_type = True, ft
                        alpha = float(a_c)
                        theta_t = float(th_c)
                        break

        # pinch detection: steps capped hard by the boundary while the
        # violation stalls CUMULATIVELY mean the Newton direction cannot
        # mend the infeasibility (a violated row's slack squeezed to ~0
        # caps every fraction-to-boundary step) — restoration mends it
        # directly. Judged over a 10-iteration window against the theta
        # where the pinch began: a slow crawl that compounds (the 118-bus
        # linear-cost DC OPF opens at alpha ~5e-3 for a few iterations,
        # then accelerates and converges in 35) must NOT be aborted —
        # round-3's 4-iteration per-step test fired on exactly that and
        # sent a healthy solve into a restoration dead end.
        if accepted and theta_k > max(10.0 * tol, 1e-8) and \
                alpha_max < 5e-2 and theta_t > 0.9 * theta_k:
            if pinched == 0:
                pinch_theta0 = theta_k
            pinched += 1
            if pinched >= 10 and theta_t > 0.98 * pinch_theta0:
                accepted = False
                pinched = 0
        else:
            pinched = 0

        if not accepted:
            # --- feasibility restoration (LM on the violation) ----------
            if theta_k <= max(10.0 * tol, 1e-8) and best is not None:
                break  # feasible yet unsteppable: return best
            if not resto_ok:
                break  # dense LM gated at scale: return best iterate
            if verbose >= 2:
                print(f"      -> restoration from theta={theta_k:.3e}")
            lam = 1e-6
            x_r = x
            theta_r = theta_k
            improved = False
            for _ in range(40):
                dxr, half_sq = resto_step(x_r, lam, pk)
                if not bool(jnp.all(jnp.isfinite(dxr))):
                    lam *= 10.0
                    continue
                x_try = x_r + dxr
                s_try = jnp.maximum(c_i_j(x_try, pk), mu) \
                    if m_i else s
                tst_r = np.asarray(metrics_p(x_try, s_try, mu, pk)[0])
                theta_try, phi_try = float(tst_r[1]), float(tst_r[2])
                if theta_try < theta_r:
                    x_r, theta_r = x_try, theta_try
                    lam = max(lam / 3.0, 1e-10)
                    if theta_r <= max(0.9 * theta_k,
                                      (1.0 - GAMMA_THETA) * theta_k) and \
                            _filter_accepts(filt, theta_r, phi_try):
                        improved = True
                        break
                else:
                    lam *= 10.0
                    if lam > 1e12:
                        break
            if not improved:
                if verbose >= 2:
                    print(f"      -> restoration failed at "
                          f"theta={theta_r:.3e} lam={lam:.1e}")
                break  # infeasible or stuck: return best iterate
            # re-enter the barrier loop from the restored point
            filt.append(((1.0 - GAMMA_THETA) * theta_k,
                         phi_k - GAMMA_PHI * theta_k))
            x = x_r
            if m_i:
                ci_r = c_i_j(x, pk)
                s = jnp.maximum(ci_r, mu)
                z = jnp.clip(z, mu / (KAPPA_SIGMA * s), KAPPA_SIGMA * mu / s)
                z = jnp.maximum(z, 1e-14)
            continue

        if verbose >= 3:
            print(f"      alpha={alpha:.3e} alpha_max={alpha_max:.3e} "
                  f"delta={delta:.1e} dphi={dphi:.3e} soc={soc_done} "
                  f"theta_t={theta_t:.3e}")
        # --- accept ------------------------------------------------------
        if not f_type:
            filt.append(((1.0 - GAMMA_THETA) * theta_k,
                         phi_k - GAMMA_PHI * theta_k))
        x = x + alpha * dx_t
        if m_e:
            y = y + alpha * dy
        if m_i:
            s = jnp.maximum(s + alpha * ds_t, 1e-300)
            z = z + alpha_z * dz
            # kappa_Sigma safeguard: project duals into a band around the
            # central path z ~ mu/s (W-B eq. 16). Weakly-active constraints
            # otherwise shoot z up by ~mu/s^2 on barrier reductions.
            z = jnp.clip(z, mu / (KAPPA_SIGMA * s), KAPPA_SIGMA * mu / s)
            z = jnp.maximum(z, 1e-14)

    if best is not None and best[0] < err:
        err, x, y, z, s = best
        converged = converged or err < tol
    # cross candidate: the degenerate endgame often IMPROVES the primal
    # (theta -> 1e-9) on iterations that destroy the duals — the best-KKT
    # duals evaluated at the most-feasible primal can beat both parents
    # (one cheap kkt_error call; round-5 pegase: best 6.7e-6 carried its
    # own theta 6e-5 while the last iterates were feasible to 1e-9)
    if err >= tol and best is not None and best_feas is not None:
        err_cross = float(kkt_error(
            best_feas[0], best[2], best[3], best_feas[3], 0.0, pk))
        if err_cross < err:
            err = err_cross
            x, s = best_feas[0], best_feas[3]
            y, z = best[2], best[3]
            best = (err, x, y, z, s)
            converged = converged or err < tol
            if verbose >= 1:
                print(f"  ipm cross candidate: kkt -> {err:.3e}")
    if err >= tol and (m_e or m_i) and recovery_ok:
        # recovery candidates: the returned (best-KKT) iterate AND the
        # most-feasible iterate seen — at a degenerate endgame only the
        # latter passes the feasibility gate (round-5 pegase finding)
        cands = [(x, s)]
        if best_feas is not None:
            cands.append((best_feas[0], best_feas[3]))
        # loose gate: the fit-first recovery polishes BOTH the equality
        # residual and the support rows, so a theta ~1e-4-grade iterate
        # is a workable seed (it guards internally against infeasible or
        # objective-worsening polish outcomes)
        gate = max(100.0 * tol, 1e-3 * max(1.0, theta0))
        for x_c, s_c in cands:
            theta_x = float(metrics(x_c, s_c, 0.0, pk)[1])
            if theta_x > gate:
                continue
            rec = _dual_recovery(x_c, s_c, err, y_seed=y, z_seed=z)
            if rec is not None and rec[0] < err:
                err, x, y, z, s = rec
                best = rec          # status reads best: keep it in sync
                converged = converged or err < tol
                if verbose >= 1:
                    print(f"  ipm dual recovery: kkt -> {err:.3e}")
            if err < acceptable_tol:
                break
    # Breaks out of the barrier loop (no factorizable KKT, feasible-yet-
    # unsteppable, restoration failure) land here with converged=False even
    # when the best iterate is, for every practical purpose, the solution —
    # e.g. the degenerate KKT left behind by removing a binding constraint
    # (remove! live-edit, optimalPowerFlow/utility.jl:303-326). Those exits
    # report status="acceptable"; `converged` keeps its STRICT meaning
    # (KKT error < tol) so existing callers' contract is unchanged —
    # success checks that tolerate the acceptable level must test
    # ``status in ("optimal", "acceptable")``.
    converged = err < tol
    acceptable = best is not None and best[0] < acceptable_tol
    status = "optimal" if converged else (
        "acceptable" if acceptable else "failed")
    # un-scale the duals: min σf s.t. Gc(x) = 0 has multipliers Gỹ/σ for
    # the original constraints (stationarity σ∇f = JᵀGỹ + ...)
    inv = 1.0 / scale_f
    y_out = np.asarray(y) * inv
    z_out = np.asarray(z) * inv
    s_out = np.asarray(s)
    if m_e and g_e is not None:
        y_out = y_out * np.asarray(g_e)
    if m_i and g_i is not None:
        z_out = z_out * np.asarray(g_i)
        s_out = s_out / np.asarray(g_i)
    return IpmResult(
        x=np.asarray(x), y=y_out, z=z_out,
        s=s_out,
        objective=float(f_j(x, pk)) / scale_f,
        converged=converged, iterations=it, kkt_error=float(err),
        status=status, f64_endgame=use_f64)
