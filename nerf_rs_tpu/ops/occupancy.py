"""Occupancy-grid empty-space skipping (NerfAcc / Instant-NGP lineage).

The reference samples uniformly along every ray (src/ray_sampling.rs:
96-142) and so spends most of its MLP evaluations in empty space. This
module maintains a coarse density grid over the scene AABB and uses it
to CONCENTRATE the (static-shape) per-ray sample budget in occupied
cells — "skipping" with static shapes: instead of compacting a
variable number of samples (dynamic shapes XLA can't compile), the same S
samples are drawn from a per-ray piecewise-constant PDF that is ~zero
in empty bins. Equal quality at a fraction of the samples/ray, which is
a direct step-time win (the MLP is the cost; samples are the axis).

Grid state is a plain (res, res, res) f32 array of EMA'd raw densities
living in TrainState (checkpointed with it). Updates are periodic and
cheap: evaluate sigma at jittered cell centers with the current params
(one jitted call, ~= one extra training step every occ_update_steps).

Layout notes: bin lookups run as three (N, B) coordinate arrays +
one flat gather — never an (N, B, 3) points tensor. All shapes static.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..config import CameraConfig, ModelConfig, RenderConfig
from ..models.mlp import Params, apply_nerf
from . import sampling


def init_grid(res: int) -> jnp.ndarray:
    """Zero-initialized grid: nothing occupied yet, so occupancy_ts
    degrades to uniform stratified sampling (eps-flat PDF) — the right
    warmup behavior."""
    return jnp.zeros((res, res, res), jnp.float32)


@partial(jax.jit, static_argnames=("model_cfg", "aabb", "dtype"))
def update_grid(
    grid: jnp.ndarray,
    params: Params,
    key: jax.Array,
    model_cfg: ModelConfig,
    aabb: float,
    decay: float = 0.95,
    dtype=jnp.bfloat16,
) -> jnp.ndarray:
    """EMA-max update: occ <- max(occ * decay, sigma(center + jitter)).

    Jitter covers the cell interior over successive updates so thin
    structures can't hide between center samples; max-EMA (NerfAcc's
    rule) makes cells sticky-occupied and only slowly reclaims space.
    """
    res = grid.shape[0]
    cell = 2.0 * aabb / res
    centers_1d = jnp.linspace(-aabb + cell / 2.0, aabb - cell / 2.0, res)
    gx, gy, gz = jnp.meshgrid(centers_1d, centers_1d, centers_1d,
                              indexing="ij")
    pts = jnp.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=-1)
    pts = pts + jax.random.uniform(
        key, pts.shape, minval=-cell / 2.0, maxval=cell / 2.0
    )
    # viewdirs don't affect sigma; a fixed direction feeds the (unused)
    # rgb head so apply_nerf's signature is satisfied. 3-D activation
    # shape, the same layout as the training path.
    pts = pts.reshape(res * res, res, 3)
    vd = jnp.zeros_like(pts).at[..., 2].set(1.0)
    sigma, _ = apply_nerf(params, pts, vd, model_cfg, dtype)
    return jnp.maximum(grid * decay, sigma.reshape(res, res, res))


def _bin_occupancy(
    origins: jnp.ndarray,  # (N, 3)
    dirs: jnp.ndarray,  # (N, 3)
    mids: jnp.ndarray,  # (B,) bin-midpoint distances
    grid: jnp.ndarray,  # (res, res, res)
    aabb: float,
) -> jnp.ndarray:
    """Raw grid density at each ray-bin midpoint: (N, B).

    Out-of-AABB points read as empty (the grid tracks the whole scene;
    anything outside it has no density to hit).
    """
    res = grid.shape[0]
    scale = res / (2.0 * aabb)
    flat = grid.reshape(-1)
    idx = []
    inside = None
    for c in range(3):
        x = origins[:, c:c + 1] + mids[None, :] * dirs[:, c:c + 1]  # (N, B)
        i = jnp.floor((x + aabb) * scale).astype(jnp.int32)
        ok = (i >= 0) & (i < res)
        inside = ok if inside is None else (inside & ok)
        idx.append(jnp.clip(i, 0, res - 1))
    lin = (idx[0] * res + idx[1]) * res + idx[2]
    vals = flat[lin]  # (N, B) gather from the flat grid
    return jnp.where(inside, vals, 0.0)


def occupancy_ts(
    key: jax.Array,
    origins: jnp.ndarray,
    dirs: jnp.ndarray,
    grid: jnp.ndarray,
    num_samples: int,
    camera: CameraConfig,
    render_cfg: RenderConfig,
    randomized: bool = True,
) -> jnp.ndarray:
    """Occupancy-guided sample distances: (N, num_samples), sorted.

    Uniform [near, far] bins are weighted by grid occupancy at their
    midpoints and the sample budget is drawn by inverse-CDF from that
    per-ray PDF — sampling.sample_pdf, the same machinery as
    hierarchical fine sampling. With an all-empty (fresh) grid this
    reduces to uniform stratified sampling.

    A uniform floor (``occ_uniform_frac`` of each ray's probability
    mass) is ALWAYS blended in. Without it, rays that hit the object
    never sample their empty bins again, the field is unsupervised
    there, and floaters grow unchecked — measured on the sparse
    lego-class scene: pure binary weights lose 7 dB (val PSNR 18.6 vs
    25.8 uniform at 1000 iters) while the blend recovers it. NerfAcc
    avoids this by also SKIPPING those bins at render; with a
    redistribution scheme the floor is the consistency mechanism.
    """
    bins, w = _occ_pdf(origins, dirs, grid, camera, render_cfg)
    # sample_pdf's stratified-CDF draws come back sorted by construction
    return sampling.sample_pdf(key, bins, w, num_samples, randomized)


def occupancy_edges(
    key: jax.Array,
    origins: jnp.ndarray,
    dirs: jnp.ndarray,
    grid: jnp.ndarray,
    num_samples: int,
    camera: CameraConfig,
    render_cfg: RenderConfig,
    randomized: bool = True,
) -> jnp.ndarray:
    """Occupancy-guided INTERVAL edges: (N, num_samples + 1), sorted.

    The interval form of occupancy_ts for the IPE family (mip-NeRF
    conical frustums consume edges, not point ts): num_samples + 1
    stratified inverse-CDF draws from the same occupancy-blended PDF
    become the edges — exactly the scheme the hierarchical IPE fine
    pass already uses (the resampled fine edges ARE sample_pdf draws,
    ops/render.py _render_rays_ipe). Edges cluster inside occupied
    bins, so frustums there are narrow (sharp encodings) while empty
    stretches are spanned by wide frustums whose IPE damping kills the
    high-frequency bands — the interval-native form of empty-space
    skipping. With a fresh (all-empty) grid this degrades to uniform
    stratified edges, the right warmup."""
    bins, w = _occ_pdf(origins, dirs, grid, camera, render_cfg)
    return sampling.sample_pdf(key, bins, w, num_samples + 1, randomized)


def _occ_pdf(origins, dirs, grid, camera: CameraConfig,
             render_cfg: RenderConfig):
    """Shared per-ray piecewise-constant PDF over [near, far]:
    (bins (N, B+1), weights (N, B)) — occupancy-thresholded bin mass
    blended with the occ_uniform_frac floor (see occupancy_ts).

    Bins follow render_cfg.sampling_space (ADVICE r4): with
    "disparity" they are even in 1/t (ops/sampling.stratified_ts's
    spacing), so the uniform floor's per-bin mass reproduces the 1/t
    sample allocation the user asked for instead of silently
    reverting to linear."""
    n = origins.shape[0]
    B = render_cfg.occ_bins
    if render_cfg.sampling_space == "disparity":
        # ascending in t: linspace runs 1/near -> 1/far (descending
        # disparity), so the reciprocal runs near -> far
        bins_1d = 1.0 / jnp.linspace(
            1.0 / camera.near, 1.0 / camera.far, B + 1)
    else:
        bins_1d = jnp.linspace(camera.near, camera.far, B + 1)
    mids = 0.5 * (bins_1d[1:] + bins_1d[:-1])
    occ = _bin_occupancy(origins, dirs, mids, grid, render_cfg.occ_aabb)
    hard = (occ > render_cfg.occ_threshold).astype(jnp.float32)
    # per-ray normalized blend: (1-a) on occupied bins, a uniform
    a = render_cfg.occ_uniform_frac
    occ_mass = hard / jnp.maximum(jnp.sum(hard, axis=-1, keepdims=True), 1.0)
    w = (1.0 - a) * occ_mass + a / B
    bins = jnp.broadcast_to(bins_1d, (n, B + 1))
    return bins, w
