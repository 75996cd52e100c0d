"""mip-NeRF 360 scene contraction (arXiv 2111.12077 eq. 10) — the
unbounded-scene parameterization.

    contract(x) = x                         for ||x|| <= 1
                  (2 - 1/||x||) * x/||x||   otherwise

maps all of R^3 into the radius-2 ball: the unit ball is untouched and
everything beyond it lands in the [1, 2) shell with resolution falling
off as 1/distance — matching the perspective footprint of a camera near
the origin, so far content gets exactly the representational capacity
it gets pixels. Composes with ANY field family (the contraction is
applied to sample positions before the encoder — PE, IPE, hash grid, or
factored lines all then operate on the bounded domain; set the family's
aabb to 2).

Capability addition over the reference, which hard-bounds its scene to
[near, far] along every ray (src/ray_sampling.rs:107-125) and has no
unbounded mode. Pairs with disparity-linear sampling
(ops/sampling.stratified_ts(space="disparity")) so the sample budget is
also spent 1/t-proportionally — the two halves of the mip-NeRF 360
unbounded recipe.

Notes: pure elementwise work on (..., 3) tensors that are
consumed immediately by the encoder matmuls, so XLA fuses the whole
thing; no gathers, no data-dependent shapes. The Gaussian variant uses
the closed-form Jacobian below rather than autodiff jvp's (3 extra
traced passes) — asserted equal to jacfwd in tests/test_contract.py.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp


def _safe_norm(x: jnp.ndarray, eps: float) -> jnp.ndarray:
    """||x|| with a finite gradient at x=0: clamp UNDER the sqrt.
    (maximum(norm(x), eps) is not enough — norm's d/dx at 0 is 0/0=NaN
    and 0*NaN through the chain rule stays NaN.)"""
    return jnp.sqrt(jnp.maximum(jnp.sum(x * x, axis=-1, keepdims=True),
                                eps * eps))


def contract(x: jnp.ndarray, eps: float = 1e-8) -> jnp.ndarray:
    """Contract points (..., 3) into the radius-2 ball (eq. 10)."""
    r = _safe_norm(x, eps)
    safe = jnp.maximum(r, 1.0)  # inside the unit ball the branch is id
    return jnp.where(r <= 1.0, x, (2.0 - 1.0 / safe) * x / safe)


def contract_gaussian(
    mean: jnp.ndarray, var: jnp.ndarray, eps: float = 1e-8
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Contract a diagonal Gaussian (mean (..., 3), var (..., 3)) by
    local linearization (mip-NeRF 360 §3: f(mu), J_f(mu) Sigma J_f(mu)^T)
    — the IPE composition rule. Returns the contracted mean and the
    DIAGONAL of the pushed-forward covariance.

    Closed-form Jacobian of f(x) = g(r) x with g(r) = 2/r - 1/r^2
    (the ||x|| > 1 branch):

        J = g(r) I + (g'(r)/r) x x^T,   g'(r) = -2/r^2 + 2/r^3

    so with diagonal Sigma = diag(s):

        diag(J Sigma J^T)_i = g^2 s_i + 2 g (g'/r) x_i^2 s_i
                              + (g'/r)^2 x_i^2 * sum_j x_j^2 s_j
    """
    r = _safe_norm(mean, eps)
    safe = jnp.maximum(r, 1.0)
    inside = r <= 1.0
    g = 2.0 / safe - 1.0 / (safe * safe)
    gp_over_r = (-2.0 / safe**2 + 2.0 / safe**3) / safe
    x2 = mean * mean
    quad = jnp.sum(x2 * var, axis=-1, keepdims=True)  # sum_j x_j^2 s_j
    var_out = (
        g * g * var
        + 2.0 * g * gp_over_r * x2 * var
        + gp_over_r * gp_over_r * x2 * quad
    )
    mean_out = jnp.where(inside, mean, g * mean)
    return mean_out, jnp.where(inside, var, jnp.maximum(var_out, 0.0))
