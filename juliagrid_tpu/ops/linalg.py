"""Mixed-precision dense linear algebra — the factorization substrate.

This replaces the reference's sparse direct solvers (KLU/UMFPACK/CHOLMOD/SPQR
reached through /root/reference/src/backend/utility.jl:470-587). The dense
path:

  * factorizes in f32,
  * solves with f64 iterative refinement: r = b - A x in f64, correction
    d = solve_f32(r), x <- x + d.

Two refinement sweeps recover ~1e-15 relative residuals for the
well-scaled power-system matrices this framework produces (Jacobians, gain
matrices, B matrices), matching the reference's f64 direct solves to its
test tolerances. All functions are pure and jit/vmap-compatible: scenario
batching maps the factorization onto batched dense kernels.

Every f32 matrix product here carries ``Precision.HIGHEST``: at default
precision a GPU may run f32 products in TF32 (about three decimal digits),
which stalls the refinement. ``solve_f64_sqd`` is the full-f64 direct
solve for systems the f32 factorization cannot carry.

The ``kind`` tags (LU / KLU / QR / LL / LDLt) mirror the reference's
factorization menu; KLU aliases LU and LDLt aliases LL (Cholesky) — they
share the dense mixed-precision path.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl

# Public factorization tags (API parity with the reference exports).
LU = "LU"
KLU = "KLU"
QR = "QR"
LL = "LL"
LDLT = "LDLt"
PW = "PW"  # Peters-Wilkinson tall LU + L-normal equations

_REFINE_STEPS = 3
_HIGHEST = jax.lax.Precision.HIGHEST


class DenseFactor(NamedTuple):
    """Factorization of a dense matrix, plus the f64 original for refinement."""

    kind: str          # static: "LU", "QR", or "LL"
    data: tuple        # factor arrays (f32)
    a64: jax.Array     # original matrix in f64 (drives refinement residuals)


def _solve_f32(kind: str, data: tuple, rhs32: jax.Array) -> jax.Array:
    if kind == "LU":
        lu, piv = data
        return jsl.lu_solve((lu, piv), rhs32)
    if kind == "QR":
        q, r = data
        y = jnp.matmul(q.T, rhs32, precision=_HIGHEST)
        return jsl.solve_triangular(r, y, lower=False)
    if kind == "LL":
        (c,) = data
        return jsl.cho_solve((c, True), rhs32)
    raise ValueError(f"unknown factorization kind {kind}")


def factorize(a64: jax.Array, kind: str = LU) -> DenseFactor:
    """Factorize in f32; keep the f64 matrix for refinement.

    Mirrors reference ``factorization`` (fresh symbolic+numeric). There is no
    symbolic phase for the dense path — refactorization is identical — so
    ``factorization!`` (numeric-only refresh) also lands here.
    """
    kind = {KLU: LU, LDLT: LL}.get(kind, kind)
    a32 = a64.astype(jnp.float32)
    if kind == LU:
        lu, piv = jsl.lu_factor(a32)
        return DenseFactor(LU, (lu, piv), a64)
    if kind == QR:
        q, r = jnp.linalg.qr(a32)
        return DenseFactor(QR, (q, r), a64)
    if kind == LL:
        c = jsl.cho_factor(a32, lower=True)[0]
        return DenseFactor(LL, (c,), a64)
    raise ValueError(f"unknown factorization kind {kind}")


def solve(factor: DenseFactor, b64: jax.Array,
          refine: int = _REFINE_STEPS) -> jax.Array:
    """Solve A x = b to f64 accuracy via mixed-precision refinement."""
    x = _solve_f32(factor.kind, factor.data, b64.astype(jnp.float32))
    x = x.astype(b64.dtype)

    def body(_, x):
        r = b64 - jnp.matmul(factor.a64, x, precision=_HIGHEST)
        d = _solve_f32(factor.kind, factor.data, r.astype(jnp.float32))
        return x + d.astype(b64.dtype)

    return jax.lax.fori_loop(0, refine, body, x)


def solve_direct(a64: jax.Array, b64: jax.Array, kind: str = LU) -> jax.Array:
    """One-shot factorize + refined solve."""
    return solve(factorize(a64, kind), b64)


@partial(jax.jit, static_argnames=("kind", "refine"))
def jit_solve_direct(a64, b64, kind: str = LU, refine: int = _REFINE_STEPS):
    return solve(factorize(a64, kind), b64, refine)


def pw_lsq_solve(a64: jax.Array, b64: jax.Array,
                 refine: int = _REFINE_STEPS) -> jax.Array:
    """Peters-Wilkinson least squares: min ||A x - b|| via tall LU.

    Factor P A = L U (rectangular partial-pivoted LU, m x k with m >= k):
    L is unit lower trapezoidal with |L_ij| <= 1, so cond(LᵀL) stays O(1)
    even when extreme measurement weights make cond(AᵀA) overflow the
    normal equations — the reference's PW method
    (acStateEstimation.jl:933-971). Solve (LᵀL) y = Lᵀ P b (Cholesky),
    then U x = y; f64 least-squares refinement drives the residual down
    with the f32 factors reused.
    """
    m, k = a64.shape
    a32 = a64.astype(jnp.float32)
    lu, _, perm = jax.lax.linalg.lu(a32)
    low = jnp.tril(lu, -1)[:, :k] + jnp.eye(m, k, dtype=jnp.float32)
    up = jnp.triu(lu[:k, :])
    ltl = jnp.matmul(low.T, low, precision=_HIGHEST)
    chol = jsl.cho_factor(ltl, lower=True)[0]

    def ls_solve32(rhs64):
        rhs32 = rhs64.astype(jnp.float32)[perm]
        y = jsl.cho_solve((chol, True),
                          jnp.matmul(low.T, rhs32, precision=_HIGHEST))
        return jsl.solve_triangular(up, y, lower=False)

    x = ls_solve32(b64).astype(b64.dtype)

    def body(_, x):
        r = b64 - jnp.matmul(a64, x, precision=_HIGHEST)
        return x + ls_solve32(r).astype(b64.dtype)

    return jax.lax.fori_loop(0, refine, body, x)


# Array-only LU helpers (vmap/shard_map-friendly: no string-tagged pytrees)

def lu_factor32(a64):
    """f32 LU factors of a f64 matrix; returns (lu, piv)."""
    return jsl.lu_factor(a64.astype(jnp.float32))


def lu_solve_refined(lu, piv, a64, b64, refine: int = _REFINE_STEPS):
    """Mixed-precision refined solve from raw (lu, piv) factors."""
    x = jsl.lu_solve((lu, piv), b64.astype(jnp.float32)).astype(b64.dtype)

    def body(_, x):
        r = b64 - jnp.matmul(a64, x, precision=_HIGHEST)
        d = jsl.lu_solve((lu, piv), r.astype(jnp.float32))
        return x + d.astype(b64.dtype)

    return jax.lax.fori_loop(0, refine, body, x)


def batched_lu_solve2(a_ii, r1, r2):
    """Per-block LU factor + two refined solves.

    a_ii: (k, n, n); r1: (k, n) or (k, n, m); r2: (k, n, m2).
    Returns (y1, y2), each block solved against its own factor."""
    lu, piv = jax.vmap(lu_factor32)(a_ii)
    y1 = jax.vmap(lu_solve_refined)(lu, piv, a_ii, r1)
    y2 = jax.vmap(lu_solve_refined)(lu, piv, a_ii, r2)
    return y1, y2


# ---------------------------------------------------------------------------
# Full-f64 direct solve — the interior-point endgame factorization.
#
# Near an interior-point active set the equilibrated KKT's condition number
# exceeds what the f32 factorization can carry (pegase: lin_res stalls above
# 1e-6 and refinement diverges — the f32 BACKWARD ERROR is the wall). The
# regularized KKT
#     [ W + Sigma + delta I      J_E^T   ]
#     [ J_E                    -delta_c I ]
# is symmetric quasi-definite (SQD) for delta, delta_c > 0; it is solved
# here by a partial-pivoted f64 LU. Used as the host-triggered fallback
# when the f32 path's linear residual check fails.
# ---------------------------------------------------------------------------

def solve_f64_sqd(a64: jax.Array, b64: jax.Array,
                  refine: int = 1) -> jax.Array:
    """One-shot f64 LU factor + solve with ``refine`` refinement sweeps."""
    factors = jsl.lu_factor(a64)
    x = jsl.lu_solve(factors, b64)

    def body(_, x):
        return x + jsl.lu_solve(factors, b64 - a64 @ x)

    return jax.lax.fori_loop(0, refine, body, x)


