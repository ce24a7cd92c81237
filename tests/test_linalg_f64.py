"""Full-f64 LU solve (the IPM endgame factorization).

Near an interior-point active set the equilibrated KKT's condition
exceeds the f32 factorization's backward error (the pegase endgame).
linalg.solve_f64_sqd must match LAPACK-grade f64 accuracy where the
f32+IR path has already lost the solution."""

import jax
import jax.numpy as jnp
import numpy as np

from juliagrid_tpu.ops import linalg


def _spd_cond(n, cond_exp, seed=0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (q * np.logspace(0, -cond_exp, n)) @ q.T


def test_f64_solve_beats_f32_at_cond_1e10():
    n = 300
    a = _spd_cond(n, 10)
    rng = np.random.default_rng(1)
    x_true = rng.standard_normal(n)
    b = a @ x_true

    x32 = np.asarray(linalg.solve(
        linalg.factorize(jnp.asarray(a), linalg.LU), jnp.asarray(b)))
    xf = np.asarray(jax.jit(linalg.solve_f64_sqd)(
        jnp.asarray(a), jnp.asarray(b)))
    xnp = np.linalg.solve(a, b)

    res = lambda x: np.max(np.abs(a @ x - b)) / np.max(np.abs(b))  # noqa
    assert res(xf) < 1e-12                 # LAPACK-grade
    assert res(xf) < 1e-4 * res(x32)       # far beyond the f32 wall
    assert np.max(np.abs(xf - x_true)) < 10 * np.max(np.abs(xnp - x_true))


def test_f64_solve_sqd_indefinite():
    """Symmetric quasi-definite KKT shape: [H+Sigma, J'; J, -dc*I] with
    Sigma spanning 1e16 — the f64 solve must stay exact."""
    rng = np.random.default_rng(2)
    n_x, m = 150, 90
    h = rng.standard_normal((n_x, n_x))
    h = h @ h.T / n_x
    sig = 10.0 ** rng.uniform(-6, 10, n_x)
    j = rng.standard_normal((m, n_x))
    a = np.zeros((n_x + m, n_x + m))
    a[:n_x, :n_x] = h + np.diag(sig) + 1e-8 * np.eye(n_x)
    a[:n_x, n_x:] = j.T
    a[n_x:, :n_x] = j
    a[n_x:, n_x:] = -1e-8 * np.eye(m)
    d = 1.0 / np.sqrt(np.maximum(np.abs(a).max(axis=1), 1e-12))
    a_s = d[:, None] * a * d[None, :]
    x_true = rng.standard_normal(n_x + m)
    b = a_s @ x_true

    xf = np.asarray(jax.jit(linalg.solve_f64_sqd)(
        jnp.asarray(a_s), jnp.asarray(b)))
    assert np.max(np.abs(a_s @ xf - b)) / np.max(np.abs(b)) < 1e-10


def test_f64_solve_odd_size_unrefined():
    """An odd (prime) size solved without a refinement sweep: the direct
    f64 factorization alone is LAPACK-grade."""
    n = 193
    a = _spd_cond(n, 4, seed=3)
    rng = np.random.default_rng(4)
    b = rng.standard_normal(n)
    xf = np.asarray(linalg.solve_f64_sqd(jnp.asarray(a), jnp.asarray(b),
                                         refine=0))
    xnp = np.linalg.solve(a, b)
    assert np.max(np.abs(xf - xnp)) < 1e-9 * max(1.0, np.max(np.abs(xnp)))
