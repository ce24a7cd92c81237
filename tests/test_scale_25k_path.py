"""Per-block LU of the BBD interior blocks (linalg.batched_lu_solve2).

The >=25k-bus BBD solve factors every interior block in one batched LU;
each block's two refined solves must match a solve against that block's
own factors, whatever the block count and size."""

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np
import pytest

from juliagrid_tpu.ops import linalg


@pytest.mark.parametrize("k,n,m", [(1, 7, 3), (4, 33, 5), (16, 64, 9)])
def test_batched_lu_solve2_matches_per_block(k, n, m):
    rng = np.random.default_rng(k * n)
    a = rng.standard_normal((k, n, n)) + n * np.eye(n)
    r1 = rng.standard_normal((k, n))
    r2 = rng.standard_normal((k, n, m))
    y1, y2 = jax.jit(linalg.batched_lu_solve2)(
        jnp.asarray(a), jnp.asarray(r1), jnp.asarray(r2))
    for b in range(k):
        factors = jsl.lu_factor(jnp.asarray(a[b]))
        np.testing.assert_allclose(
            y1[b], jsl.lu_solve(factors, jnp.asarray(r1[b])), atol=1e-12)
        np.testing.assert_allclose(
            y2[b], jsl.lu_solve(factors, jnp.asarray(r2[b])), atol=1e-12)
