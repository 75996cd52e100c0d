"""Ray-ray intersection + view-consistency diagnostics.

Port of the reference's view-consistency tooling (SURVEY §2.9, §2.21):
closed-form segment intersection with a compatibility-determinant test
(ray_intersection, src/ray_sampling.rs:184-209), pairwise all-rays
intersection collection (get_view_rays_intersections,
src/ray_sampling.rs:301-359), and the (commented-out)
measure_view_invariance metric (src/main.rs:119-248) — the mean
|sigma_1 - sigma_2| over points seen from two views.

Addition: ``density_consistency`` needs no intersection
math at all — evaluate sigma at IDENTICAL world points generated from
two view batches and compare (SURVEY §2.21 note). The intersection
variant is kept for diagnostic parity; both are vectorized.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..config import ModelConfig
from ..models.mlp import Params, apply_nerf


class Intersections(NamedTuple):
    point_a: jnp.ndarray  # (..., 3) closest point on ray a
    point_b: jnp.ndarray  # (..., 3) closest point on ray b
    s: jnp.ndarray  # (...,) parameter along a
    t: jnp.ndarray  # (...,) parameter along b
    valid: jnp.ndarray  # (...,) bool: rays actually intersect (coplanar,
    # non-parallel, parameters within segment bounds)


def ray_intersection(
    o_a: jnp.ndarray,
    d_a: jnp.ndarray,
    o_b: jnp.ndarray,
    d_b: jnp.ndarray,
    t_max: float = jnp.inf,
    tol: float = 1e-4,
) -> Intersections:
    """Closest-approach / intersection of two ray bundles, batched.

    The reference solves the 2x2 system for segment intersection and
    tests a compatibility determinant (src/ray_sampling.rs:184-209 —
    its TOL is 1e-4, src/ray_sampling.rs:18). We solve the generic
    closest-point problem: s, t minimizing |o_a + s d_a - (o_b + t d_b)|,
    flagging validity when the gap is < tol, the directions are not
    parallel, and both parameters are in [0, t_max].
    """
    r = o_b - o_a
    a = jnp.sum(d_a * d_a, -1)
    b = jnp.sum(d_a * d_b, -1)
    c = jnp.sum(d_b * d_b, -1)
    d = jnp.sum(d_a * r, -1)
    e = jnp.sum(d_b * r, -1)
    denom = a * c - b * b  # = |d_a x d_b|^2 for unit-ish dirs
    parallel = denom < tol * tol
    safe = jnp.where(parallel, 1.0, denom)
    s = jnp.where(parallel, 0.0, (c * d - b * e) / safe)
    t = jnp.where(parallel, 0.0, (b * d - a * e) / safe)
    pa = o_a + s[..., None] * d_a
    pb = o_b + t[..., None] * d_b
    gap = jnp.linalg.norm(pa - pb, axis=-1)
    valid = (
        (~parallel)
        & (gap < tol)
        & (s >= 0.0) & (s <= t_max)
        & (t >= 0.0) & (t <= t_max)
    )
    return Intersections(pa, pb, s, t, valid)


def pairwise_view_intersections(
    o_a: jnp.ndarray, d_a: jnp.ndarray, o_b: jnp.ndarray, d_b: jnp.ndarray,
    t_max: float, tol: float = 1e-3,
) -> Intersections:
    """All-pairs intersections between two ray sets (N, 3) x (M, 3) ->
    (N, M) — the vectorized get_view_rays_intersections
    (src/ray_sampling.rs:301-359, a double scalar loop there)."""
    return ray_intersection(
        o_a[:, None, :], d_a[:, None, :], o_b[None, :, :], d_b[None, :, :],
        t_max=t_max, tol=tol,
    )


def density_consistency(
    params: Params,
    model_cfg: ModelConfig,
    points: jnp.ndarray,
    pose_a: jnp.ndarray,
    pose_b: jnp.ndarray,
    dtype=None,
) -> jnp.ndarray:
    """consistency_error: mean |sigma(p)@view_a - sigma(p)@view_b|.

    For a view-independent density field this is exactly 0 by
    construction (sigma does not see the view); the probe exists to
    validate *pipelines* that bake view pose into the inputs — e.g. the
    reference's per-point rotation path — and as a regression diagnostic
    for compat mode, mirroring measure_view_invariance
    (src/main.rs:119-248).

    points are world-space (N, 3); pose_a/pose_b are applied as the
    respective view rotations before querying the field.
    """
    pa = jnp.einsum("ij,nj->ni", pose_a, points)
    pb = jnp.einsum("ij,nj->ni", pose_b, points)
    dirs = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), pa.shape)
    sig_a, _ = apply_nerf(params, pa, dirs, model_cfg, dtype)
    sig_b, _ = apply_nerf(params, pb, dirs, model_cfg, dtype)
    return jnp.mean(jnp.abs(sig_a - sig_b))


def trace_intersections_to_screen(
    inter: Intersections,
    width: int,
    height: int,
    res: int = 100,
) -> jnp.ndarray:
    """Occupancy image of intersection points projected to the screen
    plane — the headless stand-in for the reference's intersection map
    logging (log_rays_intersections, src/logging.rs:197-247) and its
    manual minifb wireframe test (src/main.rs:250-264)."""
    pts = inter.point_a.reshape(-1, 3)
    valid = inter.valid.reshape(-1)
    x = jnp.clip(((pts[:, 0] + 2.0) / 4.0 * res).astype(jnp.int32), 0, res - 1)
    y = jnp.clip(((pts[:, 1] + 2.0) / 4.0 * res).astype(jnp.int32), 0, res - 1)
    img = jnp.zeros((res, res))
    img = img.at[y, x].add(valid.astype(jnp.float32))
    m = jnp.max(img)
    return jnp.where(m > 0, img / m, img)
