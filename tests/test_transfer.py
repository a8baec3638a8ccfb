"""The multi-bounce transfer of the differentiable estimator (the product
path's one float32 contraction) against a float64 NumPy reference
(the `transfer_case` fixture, tests/conftest.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

from uvtrace.diff.estimator import _neumann_sum


@pytest.mark.parametrize("n_bounces", [1, 2, 3, 4])
def test_neumann_sum_matches_float64(transfer_case, n_bounces):
    e_dir, rho, f, w, reference = transfer_case
    got = _neumann_sum(jnp.asarray(e_dir, jnp.float32), jnp.asarray(rho, jnp.float32),
                       jnp.asarray(f, jnp.float32), w, n_bounces)
    np.testing.assert_allclose(np.asarray(got), reference(n_bounces), rtol=2e-6)
