"""Differentiable volume rendering (alpha compositing) + full ray renderer.

O(N) transmittance via an exclusive cumulative sum — replacing the
reference's O(N^2) per-sample prefix re-reduction
(accumulated_transmittance, src/model.rs:221-241) with
T_i = exp(-cumsum_excl(sigma*delta)) — and the end-to-end
rays -> pixels pipeline (sample, encode, MLP, composite) used by both
training and novel-view rendering.

Weight/color semantics match the reference's eq.(3) implementation
(src/model.rs:243-246): w_i = T_i * (1 - exp(-sigma_i * delta_i)),
C = sum_i w_i c_i; capability additions are white-background
compositing (Blender scenes), depth/acc maps, and hierarchical
coarse+fine rendering.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import CameraConfig, ModelConfig, RenderConfig
from ..models.mlp import Params, apply_nerf
from . import sampling


class RenderOut(NamedTuple):
    rgb: jnp.ndarray  # (..., 3) composited color
    weights: jnp.ndarray  # (..., S) compositing weights
    sigma: jnp.ndarray  # (..., S) densities (post-activation)
    depth: jnp.ndarray  # (...,) expected termination depth
    acc: jnp.ndarray  # (...,) accumulated opacity
    ts: Optional[jnp.ndarray] = None  # (..., S) sample distances of this
    # pass (regularizers like distortion_loss need them next to weights)
    deltas: Optional[jnp.ndarray] = None  # (..., S) exact interval
    # lengths — set by the IPE (interval) paths, where ts are midpoints
    # and the shifted-diff delta convention would be an O(dt^2)
    # approximation (ADVICE r4); point paths leave it None


def composite(
    sigma: jnp.ndarray,
    colors: jnp.ndarray,
    deltas: jnp.ndarray,
    white_background: bool = False,
    ts: Optional[jnp.ndarray] = None,
) -> RenderOut:
    """Alpha-composite per-sample (sigma, color) into pixel colors.

    Args:
      sigma: (..., S) densities.
      colors: (..., S, C) per-sample colors.
      deltas: (..., S) inter-sample distances (see
        sampling.deltas_from_ts).
      white_background: composite onto white using residual
        transmittance (needed for the Blender synthetic scenes).
      ts: optional (..., S) sample distances for the depth map.

    T_i = exp(-sum_{j<i} sigma_j delta_j) computed as one exclusive
    cumsum (the reference re-reduces the prefix per sample — O(S^2),
    src/model.rs:221-241; this is the O(S) form, SURVEY §7
    step 5).
    """
    sd = sigma * deltas
    accum = jnp.cumsum(sd, axis=-1)
    excl = accum - sd  # exclusive prefix: sum_{j<i}
    trans = jnp.exp(-excl)
    alpha = 1.0 - jnp.exp(-sd)
    weights = trans * alpha
    rgb = jnp.sum(weights[..., None] * colors, axis=-2)
    acc = jnp.sum(weights, axis=-1)
    if ts is not None:
        depth = jnp.sum(weights * ts, axis=-1)
    else:
        depth = jnp.zeros_like(acc)
    if white_background:
        rgb = rgb + (1.0 - acc[..., None])
    return RenderOut(rgb=rgb, weights=weights, sigma=sigma, depth=depth,
                     acc=acc, ts=ts)


def distortion_loss(
    weights: jnp.ndarray,
    ts: jnp.ndarray,
    near: float,
    far: float,
    space: str = "linear",
    deltas: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """mip-NeRF 360 distortion loss (eq. 15, arXiv 2111.12077), adapted
    to point samples: with s = the sample positions normalized to
    [0, 1] over [near, far] and d their normalized deltas,

        L = sum_ij w_i w_j |s_i - s_j| + (1/3) sum_i w_i^2 d_i

    per ray, returned as the mean over rays. Concentrates each ray's
    weight mass into one compact cluster — the standard floater /
    background-collapse regularizer modern NeRF stacks ship (the
    reference has no regularizers at all, src/model.rs:296-299).

    The O(S^2) double sum is computed O(S) with inclusive prefix sums
    over the (sorted-by-construction) sample axis:
        sum_j w_j |s_i - s_j| = s_i (2 cw_i - W) + M - 2 cwm_i
    with cw/cwm the inclusive cumsums of w and w*s, W/M their totals.

    Sample positions are treated as values (stop-gradient), matching
    mip-NeRF 360 — only the weights receive gradient.

    ``deltas`` (the interval/IPE path): ``ts`` are interval MIDPOINTS
    and ``deltas`` exact interval lengths — the s-space lengths are
    computed exactly (disparity: dt / ((mid - dt/2)(mid + dt/2)),
    ADVICE r4) instead of via the shifted-diff point convention.
    """
    ts = jax.lax.stop_gradient(ts)
    if deltas is not None:
        deltas = jax.lax.stop_gradient(deltas)
    if space == "disparity":
        # normalize in the SAMPLING space (mip-NeRF 360 defines the loss
        # over s, the normalized ray coordinate — disparity for
        # unbounded configs): s = (1/near - 1/t) / (1/near - 1/far),
        # monotone increasing in t so the prefix-sum identity holds
        g0, g1 = 1.0 / near, 1.0 / far
        s = (g0 - 1.0 / ts) / (g0 - g1)
        if deltas is not None:
            d = deltas / ((ts - 0.5 * deltas) * (ts + 0.5 * deltas)
                          ) / (g0 - g1)
        else:
            last = jnp.ones_like(s[..., :1])
            d = jnp.concatenate([s[..., 1:], last], axis=-1) - s
    else:
        inv_span = 1.0 / (far - near)
        s = (ts - near) * inv_span
        d = (deltas if deltas is not None
             else sampling.deltas_from_ts(ts, far)) * inv_span
    cw = jnp.cumsum(weights, axis=-1)
    cwm = jnp.cumsum(weights * s, axis=-1)
    w_tot = cw[..., -1:]
    m_tot = cwm[..., -1:]
    a = s * (2.0 * cw - w_tot) + m_tot - 2.0 * cwm
    per_ray = jnp.sum(weights * a + weights * weights * d / 3.0, axis=-1)
    return jnp.mean(per_ray)


def compat_predict(
    params: Params,
    points: jnp.ndarray,
    ts: jnp.ndarray,
    model_cfg: ModelConfig,
    far: float,
    dtype=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Reference NeRF::predict semantics (src/model.rs:152-209).

    Evaluates the compat MLP on pre-rotated world points, computes the
    radiance head output then DISCARDS it (as committed, model.rs:178),
    and composites stacked raw densities as grayscale color with an
    alpha=1 channel (model.rs:190-206). Returns ((..., 4) colors,
    (..., S) densities) like the reference.
    """
    sigma, _rgba = apply_nerf(params, points, None, model_cfg, dtype)
    deltas = sampling.deltas_from_ts(ts, far)
    ones = jnp.ones_like(sigma)
    colors = jnp.stack([sigma, sigma, sigma, ones], axis=-1)
    out = composite(sigma, colors, deltas, white_background=False, ts=ts)
    return out.rgb, sigma


def _render_rays_ipe(
    params: Params,
    flat_o: jnp.ndarray,
    flat_d: jnp.ndarray,
    key: jax.Array,
    model_cfg: ModelConfig,
    render_cfg: RenderConfig,
    camera: CameraConfig,
    rand: bool,
    dtype,
    n_rays_shape,
    fine_params: Optional[Params] = None,
    radii: Optional[jnp.ndarray] = None,
    grid=None,
):
    """mip-NeRF rendering (arXiv 2103.13415): stratified INTERVAL edges
    along a cone per ray, each interval a conical-frustum Gaussian
    encoded with IPE (models/encoding.integrated_posenc), composited
    over exact interval lengths. Hierarchical resampling draws new
    edges from the coarse weight histogram; fine_mode picks mip-NeRF's
    standalone compositing of the resampled intervals or the NeRF-style
    union (fine pass over the MERGED coarse+resampled edge set — the
    composition the occ/union quality records use). With an occupancy
    ``grid``, the coarse edges are occupancy-guided draws
    (ops/occupancy.occupancy_edges) instead of uniform-stratified.
    (one MLP unless a separate fine net is configured.)
    """
    from . import sampling

    n = flat_o.shape[0]
    S = render_cfg.num_samples
    k_coarse, k_fine = jax.random.split(key)
    # per-ray radii (multiscale training) broadcast over the interval
    # axis inside conical_gaussians; scalar = the camera's footprint
    base_r = (sampling.pixel_radius(camera) if radii is None
              else radii[:, None])
    viewdirs = flat_d / jnp.linalg.norm(flat_d, axis=-1, keepdims=True)
    noise_std = render_cfg.raw_noise_std if rand else 0.0

    def ipe_pass(pass_params, edges, noise_key):
        mean, var, t_mids, deltas = sampling.conical_gaussians(
            flat_o, flat_d, edges, base_r
        )
        sigma, rgb = apply_nerf(
            pass_params, mean, viewdirs[..., None, :], model_cfg, dtype,
            noise_std=noise_std, noise_key=noise_key, pos_var=var,
        )
        return composite(
            sigma, rgb[..., :3], deltas,
            white_background=render_cfg.white_background, ts=t_mids,
        )._replace(deltas=deltas)

    if grid is not None and not render_cfg.compat_sampling:
        from . import occupancy

        edges = occupancy.occupancy_edges(
            k_coarse, flat_o, flat_d, grid, S, camera, render_cfg, rand,
        )
    else:
        edges = sampling.stratified_ts(
            k_coarse, n, S + 1, camera.near, camera.far, rand,
            space=render_cfg.sampling_space,
        )
    coarse = ipe_pass(params, edges, jax.random.fold_in(k_coarse, 1))

    fine = None
    if render_cfg.num_fine_samples > 0:
        # resample S_f + 1 new edges from the coarse interval histogram
        # (the edges ARE the histogram bins — no midpoint construction)
        fine_edges = sampling.sample_pdf(
            k_fine, edges, coarse.weights,
            render_cfg.num_fine_samples + 1, rand,
        )
        if render_cfg.fine_mode != "standalone":
            # union composition: the fine pass evaluates the MERGED
            # coarse+resampled edge set (S + S_f + 1 intervals) — the
            # interval analog of NeRF §5.2's combined sample set
            fine_edges = sampling.merge_ts(edges, fine_edges)
        fine = ipe_pass(
            fine_params if fine_params is not None else params,
            fine_edges, jax.random.fold_in(k_fine, 1),
        )

    def unflatten(out: RenderOut) -> RenderOut:
        return RenderOut(
            rgb=out.rgb.reshape(*n_rays_shape, 3),
            weights=out.weights.reshape(*n_rays_shape, -1),
            sigma=out.sigma.reshape(*n_rays_shape, -1),
            depth=out.depth.reshape(n_rays_shape),
            acc=out.acc.reshape(n_rays_shape),
            ts=out.ts.reshape(*n_rays_shape, -1),
            deltas=(None if out.deltas is None
                    else out.deltas.reshape(*n_rays_shape, -1)),
        )

    return unflatten(coarse), (unflatten(fine) if fine is not None else None)


def render_rays(
    params: Params,
    origins: jnp.ndarray,
    dirs: jnp.ndarray,
    key: jax.Array,
    model_cfg: ModelConfig,
    render_cfg: RenderConfig,
    camera: CameraConfig,
    fine_params: Optional[Params] = None,
    randomized: Optional[bool] = None,
    dtype=None,
    grid: Optional[jnp.ndarray] = None,
    prop_params: Optional[Params] = None,
    prop_cfg=None,
    radii: Optional[jnp.ndarray] = None,
) -> Tuple[RenderOut, Optional[RenderOut]]:
    """Full per-ray rendering: sample -> MLP -> composite, with optional
    hierarchical fine pass (NeRF §5.2 / BASELINE config 3).

    Rays of any leading shape (N,) or (H, W). Returns (coarse, fine)
    RenderOuts; fine is None when num_fine_samples == 0.

    prop_params/prop_cfg (ops/proposal.py): the main pass's
    num_samples points are proposal-guided instead of uniform; the
    interlevel training loss lives in train/step.py — here the proposal
    only picks where to sample.
    """
    rand = render_cfg.randomized if randomized is None else randomized
    n_rays_shape = origins.shape[:-1]
    flat_o = origins.reshape(-1, 3)
    flat_d = dirs.reshape(-1, 3)
    n = flat_o.shape[0]
    k_coarse, k_fine = jax.random.split(key)

    if model_cfg.ipe:
        return _render_rays_ipe(
            params, flat_o, flat_d, key, model_cfg, render_cfg, camera,
            rand, dtype, n_rays_shape, fine_params=fine_params,
            radii=None if radii is None else radii.reshape(-1),
            grid=grid,
        )

    if prop_params is not None and not render_cfg.compat_sampling:
        from . import proposal as prop_ops

        ts, _ = prop_ops.proposal_resample(
            k_coarse, flat_o, flat_d, prop_params, prop_cfg,
            render_cfg.num_samples, camera, rand, dtype,
            space=render_cfg.sampling_space, contract=model_cfg.contract,
        )
    elif grid is not None and not render_cfg.compat_sampling:
        # occupancy-guided sampling: the budget concentrates in occupied
        # grid cells (ops/occupancy.py; empty-space skipping)
        from . import occupancy

        ts = occupancy.occupancy_ts(
            k_coarse, flat_o, flat_d, grid, render_cfg.num_samples,
            camera, render_cfg, rand,
        )
    elif render_cfg.compat_sampling:
        ts = sampling.compat_ts(k_coarse, n, render_cfg.num_samples, camera.far, rand)
    else:
        ts = sampling.stratified_ts(
            k_coarse, n, render_cfg.num_samples, camera.near, camera.far,
            rand, space=render_cfg.sampling_space,
        )

    viewdirs = flat_d / jnp.linalg.norm(flat_d, axis=-1, keepdims=True)

    # paper-appendix sigma regularizer: noise is added to RAW sigma
    # inside apply_nerf (pre-activation, as the paper specifies) with
    # a DISTINCT key per pass (coarse/fine noise must be independent)
    noise_std = (
        render_cfg.raw_noise_std
        if (render_cfg.raw_noise_std > 0.0 and rand)
        else 0.0
    )

    def field_eval(pass_params: Params, pts: jnp.ndarray,
                   noise_key) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Per-sample (sigma, rgb) of the field."""
        return apply_nerf(
            pass_params, pts, viewdirs[..., None, :], model_cfg, dtype,
            noise_std=noise_std, noise_key=noise_key,
        )

    def run_pass(pass_params: Params, ts_pass: jnp.ndarray,
                 noise_key=None) -> RenderOut:
        pts = sampling.points_from_ts(flat_o, flat_d, ts_pass)
        sigma, rgb = field_eval(pass_params, pts, noise_key)
        deltas = sampling.deltas_from_ts(ts_pass, camera.far)
        if render_cfg.compat_density_color:
            colors = jnp.stack([sigma, sigma, sigma], axis=-1)
        else:
            colors = rgb[..., :3]
        return composite(
            sigma, colors, deltas,
            white_background=render_cfg.white_background, ts=ts_pass,
        )

    # shared-network hierarchical fast path (RenderConfig.share_network):
    # ONE network serves both passes, so the fine pass evaluates ONLY the
    # new fine samples and composites the union from the coarse pass's
    # cached per-sample (sigma, rgb) — the paper's two-MLP scheme
    # re-evaluates every coarse point through the fine MLP
    # (S_c + S_f MLP rows/ray vs this path's S_f).
    standalone = render_cfg.fine_mode == "standalone"
    shared_fast = (
        render_cfg.share_network
        and not standalone
        and render_cfg.num_fine_samples > 0
        and fine_params is None
        and not render_cfg.compat_density_color
    )

    fine = None
    if shared_fast:
        pts_c = sampling.points_from_ts(flat_o, flat_d, ts)
        sigma_c, rgb_c = field_eval(
            params, pts_c, jax.random.fold_in(k_coarse, 1)
        )
        coarse = composite(
            sigma_c, rgb_c[..., :3], sampling.deltas_from_ts(ts, camera.far),
            white_background=render_cfg.white_background, ts=ts,
        )
        mids = 0.5 * (ts[..., 1:] + ts[..., :-1])
        bins = jnp.concatenate([ts[..., :1], mids, ts[..., -1:]], axis=-1)
        fine_ts = sampling.sample_pdf(
            k_fine, bins, coarse.weights, render_cfg.num_fine_samples, rand
        )
        pts_f = sampling.points_from_ts(flat_o, flat_d, fine_ts)
        sigma_f, rgb_f = field_eval(
            params, pts_f, jax.random.fold_in(k_fine, 1)
        )
        # merge by ONE multi-operand lax.sort carrying sigma + the rgb
        # channels as separate (N, 2S) scalar payloads: every operand
        # stays 2-D and gather-free (a take_along_axis gather of an
        # (N, 2S, 3) color tensor costs a scatter in the backward)
        cat = lambda a, b: jnp.concatenate([a, b], axis=-1)
        ts_s, sigma_u, r_u, g_u, b_u = jax.lax.sort(
            (cat(ts, fine_ts), cat(sigma_c, sigma_f),
             cat(rgb_c[..., 0], rgb_f[..., 0]),
             cat(rgb_c[..., 1], rgb_f[..., 1]),
             cat(rgb_c[..., 2], rgb_f[..., 2])),
            num_keys=1,
        )
        # channel-wise compositing: all intermediates stay (N, 2S) 2-D
        deltas_u = sampling.deltas_from_ts(ts_s, camera.far)
        sd = sigma_u * deltas_u
        trans = jnp.exp(-(jnp.cumsum(sd, axis=-1) - sd))
        w = trans * (1.0 - jnp.exp(-sd))
        rgb_out = jnp.stack(
            [jnp.sum(w * c, axis=-1) for c in (r_u, g_u, b_u)], axis=-1
        )
        acc_u = jnp.sum(w, axis=-1)
        if render_cfg.white_background:
            rgb_out = rgb_out + (1.0 - acc_u[..., None])
        fine = RenderOut(rgb=rgb_out, weights=w, sigma=sigma_u,
                         depth=jnp.sum(w * ts_s, axis=-1), acc=acc_u,
                         ts=ts_s)
    else:
        coarse = run_pass(params, ts,
                          noise_key=jax.random.fold_in(k_coarse, 1))
        if render_cfg.num_fine_samples > 0:
            mids = 0.5 * (ts[..., 1:] + ts[..., :-1])
            bins = jnp.concatenate(
                [ts[..., :1], mids, ts[..., -1:]], axis=-1
            )  # (N, S+1)
            fine_ts = sampling.sample_pdf(
                k_fine, bins, coarse.weights, render_cfg.num_fine_samples, rand
            )
            if standalone:
                # proposal-style: the fine pass stands alone on its own
                # (already PDF-concentrated, sorted-by-construction)
                # samples — no union sort, no coarse re-evaluation
                all_ts = fine_ts
            else:
                all_ts = sampling.merge_ts(ts, fine_ts)
            fine = run_pass(
                fine_params if fine_params is not None else params,
                all_ts,
                noise_key=jax.random.fold_in(k_fine, 1),
            )

    def unflatten(out: RenderOut) -> RenderOut:
        return RenderOut(
            rgb=out.rgb.reshape(*n_rays_shape, 3),
            weights=out.weights.reshape(*n_rays_shape, -1),
            sigma=out.sigma.reshape(*n_rays_shape, -1),
            depth=out.depth.reshape(n_rays_shape),
            acc=out.acc.reshape(n_rays_shape),
            ts=(out.ts.reshape(*n_rays_shape, -1)
                if out.ts is not None else None),
        )

    return unflatten(coarse), (unflatten(fine) if fine is not None else None)


def mse(pred: jnp.ndarray, gold: jnp.ndarray) -> jnp.ndarray:
    """MSE loss (reference mse_loss, src/model.rs:296-299)."""
    return jnp.mean((pred - gold) ** 2)


def psnr_from_mse(m: jnp.ndarray) -> jnp.ndarray:
    """PSNR in dB for [0,1] images — the quality metric of record
    (BASELINE.md) the reference never computes."""
    return -10.0 / jnp.log(10.0) * jnp.log(jnp.maximum(m, 1e-10))


def psnr(pred: jnp.ndarray, gold: jnp.ndarray) -> jnp.ndarray:
    return psnr_from_mse(mse(pred, gold))
