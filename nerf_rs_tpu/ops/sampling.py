"""Point sampling along rays: stratified, compat, and hierarchical.

Vectorized replacement for the reference's scalar per-ray sampling loop
(src/ray_sampling.rs:96-142): everything is generated on-device from
explicit PRNG keys (the reference uses unseeded rand::random,
src/ray_sampling.rs:110), batched over rays, with static shapes so the
whole pipeline stays inside one jitted program.

Two sampling modes:
  * paper: true stratified bins in [near, far] (NeRF eq. 2) — what the
    reference *intended* (its near plane is silenced by a precedence
    quirk, src/ray_sampling.rs:114).
  * compat: t = u * far in [0, far), sorted — the reference's effective
    behavior, kept for pixel-parity testing (SURVEY.md §7 stance).

Plus inverse-CDF hierarchical resampling (NeRF §5.2) for the fine
network, which the reference lacks but BASELINE config 3 requires.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def stratified_ts(
    key: jax.Array,
    num_rays: int,
    num_samples: int,
    near: float,
    far: float,
    randomized: bool = True,
    space: str = "linear",
) -> jnp.ndarray:
    """Stratified sample distances: (num_rays, num_samples), sorted.

    Partitions [near, far] into num_samples even bins and draws one
    uniform sample per bin (NeRF eq. 2). With randomized=False, returns
    bin midpoints (deterministic eval).

    ``space="disparity"`` stratifies in 1/t instead (mip-NeRF 360's
    unbounded-scene spacing, arXiv 2111.12077 §2 — LLFF-lineage
    "lindisp"): bins are even in disparity between 1/near and 1/far, so
    the sample budget falls off as 1/t^2 in metric distance — matching
    both the perspective footprint and the scene contraction's radial
    compression (ops/contract.py). Requires near > 0 (Config validates).
    Returned ts are still ASCENDING in t — disparity bins are laid out
    descending so every downstream consumer (deltas, merge, compositing)
    keeps its sorted-by-construction invariant.
    """
    if space == "disparity":
        bins = 1.0 / jnp.linspace(1.0 / near, 1.0 / far, num_samples + 1)
    else:
        assert space == "linear", space
        bins = jnp.linspace(near, far, num_samples + 1)
    lower, upper = bins[:-1], bins[1:]
    if randomized:
        u = jax.random.uniform(key, (num_rays, num_samples))
    else:
        u = jnp.full((num_rays, num_samples), 0.5)
    return lower + (upper - lower) * u


def compat_ts(
    key: jax.Array,
    num_rays: int,
    num_samples: int,
    far: float,
    randomized: bool = True,
) -> jnp.ndarray:
    """Reference-compatible sample distances.

    Reproduces src/ray_sampling.rs:107-125 exactly: randomized draws
    t = u * far over [0, far) then sorts; deterministic uses
    t = i/n * far (already sorted). The nominal near-plane offset is
    absent on purpose — ``t *= (T_FAR - HITHER) + HITHER`` parses as
    ``t * T_FAR`` (the quirk documented in SURVEY.md §2.8).
    """
    if randomized:
        t = jax.random.uniform(key, (num_rays, num_samples)) * far
        return jnp.sort(t, axis=-1)
    t = jnp.arange(num_samples, dtype=jnp.float32) / num_samples * far
    return jnp.broadcast_to(t, (num_rays, num_samples))


def deltas_from_ts(ts: jnp.ndarray, far: float) -> jnp.ndarray:
    """Adjacent-sample distances with the far plane as last exit.

    delta_i = t_{i+1} - t_i, with t_{N} := far appended — the
    reference's eq.(3) deltas (src/model.rs:184-187). (The original
    paper uses an effectively-infinite last delta; using ``far`` matches
    the reference and bounds the last sample's alpha.)
    """
    last = jnp.full(ts.shape[:-1] + (1,), far, dtype=ts.dtype)
    return jnp.concatenate([ts[..., 1:], last], axis=-1) - ts


def points_from_ts(
    origins: jnp.ndarray, dirs: jnp.ndarray, ts: jnp.ndarray
) -> jnp.ndarray:
    """World-space sample points o + t*d: (..., S, 3).

    The vectorized form of src/ray_sampling.rs:115 after the pose has
    already been applied to (o, d) once (see ops/rays.py).
    """
    return origins[..., None, :] + ts[..., :, None] * dirs[..., None, :]


def conical_gaussians(
    origins: jnp.ndarray,
    dirs: jnp.ndarray,
    edges: jnp.ndarray,
    base_radius: float,
):
    """Per-interval conical-frustum Gaussians for mip-NeRF IPE
    (arXiv 2103.13415 eqs. 7 + 16, the stable reparameterization).

    Each of the S = edges.shape[-1]-1 intervals [t0, t1] along a cone of
    base radius ``base_radius`` (the pixel footprint at unit distance;
    a scalar, or a (..., 1) per-ray array for multiscale batches)
    is approximated by a Gaussian with mean o + t_mean * d and a
    diagonal covariance split into an along-ray variance t_var and a
    perpendicular variance r_var. t_mean is the frustum's exact center
    of mass in t (density ~ t^2, the cone's cross-section area):
    E[t] = mu + 2 mu hw^2 / (3 mu^2 + hw^2) for mu = (t0+t1)/2,
    hw = (t1-t0)/2 — asserted against the closed integral in tests.

    Returns (mean (..., S, 3), var (..., S, 3), t_mids (..., S),
    deltas (..., S)); deltas are the exact interval lengths (no far
    append — the last edge IS the far plane).
    """
    t0, t1 = edges[..., :-1], edges[..., 1:]
    mu = 0.5 * (t0 + t1)
    hw = 0.5 * (t1 - t0)
    mu2, hw2 = mu * mu, hw * hw
    denom = 3.0 * mu2 + hw2
    t_mean = mu + 2.0 * mu * hw2 / denom
    t_var = hw2 / 3.0 - (4.0 / 15.0) * (
        hw2 * hw2 * (12.0 * mu2 - hw2) / (denom * denom)
    )
    r_var = base_radius * base_radius * (
        mu2 / 4.0 + (5.0 / 12.0) * hw2 - (4.0 / 15.0) * hw2 * hw2 / denom
    )
    d2 = dirs * dirs  # (..., 3)
    dnorm2 = jnp.maximum(
        jnp.sum(d2, axis=-1, keepdims=True), 1e-10
    )
    mean = origins[..., None, :] + t_mean[..., :, None] * dirs[..., None, :]
    var = (
        t_var[..., :, None] * d2[..., None, :]
        + r_var[..., :, None] * (1.0 - d2[..., None, :] / dnorm2[..., None, :])
    )
    return mean, var, mu, t1 - t0


def pixel_radius(camera) -> float:
    """Pixel footprint at unit distance along the ray: the cone base
    radius for mip-NeRF sampling (2/sqrt(12) x the pixel's world width,
    the mip-NeRF convention)."""
    import math

    focal = camera.focal
    if focal is None:
        focal = 0.5 * camera.width / math.tan(0.5 * camera.fov)
    return float(2.0 / math.sqrt(12.0) / focal)


def sample_pdf(
    key: jax.Array,
    bins: jnp.ndarray,
    weights: jnp.ndarray,
    num_samples: int,
    randomized: bool = True,
    eps: float = 1e-5,
) -> jnp.ndarray:
    """Inverse-CDF sampling of a piecewise-constant ray PDF (NeRF §5.2).

    Used for hierarchical fine-network sampling: ``bins`` (..., B+1) are
    coarse t-boundaries, ``weights`` (..., B) the coarse compositing
    weights. Returns (..., num_samples) new ts, SORTED per ray — the
    randomized draw is stratified in CDF space (one jittered sample per
    equal-mass bin), so u is monotone per ray and the CDF inverse
    preserves order with no sort op; stratified draws are also
    lower-variance than iid uniforms (the paper's eq. 2 argument,
    applied in CDF space).

    The reference has no hierarchical sampling; this implements the
    capability named by BASELINE.json config 3.
    """
    weights = weights + eps  # avoid nans on empty rays
    pdf = weights / jnp.sum(weights, axis=-1, keepdims=True)
    cdf = jnp.cumsum(pdf, axis=-1)
    cdf = jnp.concatenate([jnp.zeros_like(cdf[..., :1]), cdf], axis=-1)

    shape = cdf.shape[:-1] + (num_samples,)
    if randomized:
        u = (
            jnp.arange(num_samples, dtype=jnp.float32)
            + jax.random.uniform(key, shape)
        ) / num_samples
    else:
        u = jnp.linspace(0.0, 1.0 - 1e-6, num_samples)
        u = jnp.broadcast_to(u, shape)

    # interval location WITHOUT gathers: one broadcast compare and
    # masked max/min reductions pick the bracketing cdf/bin entries
    # directly (pure vector work, no per-row dynamic gathers).
    mask = u[..., :, None] >= cdf[..., None, :]  # (..., F, B+1)

    def below(x):  # last True position's value (x monotone, (..., B+1))
        return jnp.max(jnp.where(mask, x[..., None, :], x[..., None, :1]),
                       axis=-1)

    def above(x):  # first False position's value
        return jnp.min(jnp.where(mask, x[..., None, -1:], x[..., None, :]),
                       axis=-1)

    cdf_below, cdf_above = below(cdf), above(cdf)
    bins_below, bins_above = below(bins), above(bins)

    denom = cdf_above - cdf_below
    denom = jnp.where(denom < eps, 1.0, denom)
    frac = (u - cdf_below) / denom
    samples = bins_below + frac * (bins_above - bins_below)
    return jax.lax.stop_gradient(samples)


def merge_ts(coarse_ts: jnp.ndarray, fine_ts: jnp.ndarray) -> jnp.ndarray:
    """Union of coarse+fine sample distances, sorted per ray (NeRF §5.2:
    the fine network evaluates the combined sample set).

    Both inputs are sorted by construction (stratified bins; stratified-
    CDF sample_pdf), so this is a 2-way MERGE, not a sort — and XLA's
    general sort is the op class that measured ~30 ms on a (4096, 128)
    batch (see sample_pdf). Instead, broadcast-compare counting:
    each element's final position is its own rank plus the count of
    smaller elements in the other array (ties: coarse first), which is a
    permutation of [0, S); the merged row is recovered with an
    equality-one-hot weighted sum — pure vector work, no dynamic
    gathers, no sort.
    """
    a, b = coarse_ts, fine_ts
    sa, sb = a.shape[-1], b.shape[-1]
    # final position = own rank + strictly-smaller (resp. <=) count in
    # the other array; <=/< tiebreak makes pos a permutation even with
    # duplicated values across the two arrays
    pa = jnp.arange(sa) + jnp.sum(
        b[..., None, :] < a[..., :, None], axis=-1
    )
    pb = jnp.arange(sb) + jnp.sum(
        a[..., None, :] <= b[..., :, None], axis=-1
    )
    vals = jnp.concatenate([a, b], axis=-1)
    pos = jnp.concatenate([pa, pb], axis=-1)
    # merged[k] = sum_i [pos_i == k] * vals_i  (one-hot row sum; the
    # compare+select+reduce fuses — the (S, S) mask never materializes)
    k = jnp.arange(sa + sb)
    return jnp.sum(
        jnp.where(pos[..., None, :] == k[:, None], vals[..., None, :], 0.0),
        axis=-1,
    )
