"""Factored (CP-decomposed) multiresolution radiance field — the
gather-free fast-field family (TensoRF lineage, arXiv 2203.09517's CP
branch, multi-scale like Instant-NGP's level pyramid).

This family replaces the hash grid's 3-D table lookup with dense
matrix products:

  * Per axis a and point n, a 2-hot-per-level "hat basis" row
    W_a[n, :] over the concatenated level grids (resolutions like
    NGP's geometric pyramid) — built with elementwise arithmetic
    (relu(1 - |u*R - knot|)) that XLA fuses into the matmul operand.
  * One matmul per axis against a dense (sumR, C) line matrix;
    because the matrix is dense across levels, each output channel is
    a learned piecewise-linear function with knots from EVERY level
    (free cross-scale mixing — masking it back to block-diagonal would
    cost the same FLOPs).
  * The encoding is the CP product across the three axes:
    enc[n, c] = X[n, c] * Y[n, c] * Z[n, c] — rank-C canonical
    polyadic decomposition of the feature volume.
  * Tiny shared sigma/color heads (models/hashgrid.py
    init/apply_tiny_heads), same contract as every other family.

Zero gathers anywhere: encode FLOPs ~ 3 * N * sumR * C * 2, all matmul.

The reference has a single fixed MLP (src/model.rs:45-93); SURVEY §2.11
maps it to this framework's model families.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ModelConfig
from .hashgrid import apply_tiny_heads, init_tiny_heads

Params = Dict[str, Any]


def fac_resolutions(cfg: ModelConfig) -> List[int]:
    """Geometric resolution ladder base..max, like the hash pyramid."""
    L = cfg.fac_levels
    if L == 1:
        return [cfg.fac_base_res]
    b = math.exp(
        (math.log(cfg.fac_max_res) - math.log(cfg.fac_base_res)) / (L - 1)
    )
    return [int(math.floor(cfg.fac_base_res * (b ** l))) for l in range(L)]


def knot_constants(cfg: ModelConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Per-column (knot) constants of the concatenated level grids:
    (res[j], knot[j]) so that column j holds the hat function centered
    at knot[j] of a level with resolution res[j]. A level of
    resolution R contributes R+1 knots (both endpoints)."""
    res, knot = [], []
    for r in fac_resolutions(cfg):
        res.extend([r] * (r + 1))
        knot.extend(range(r + 1))
    return np.asarray(res, np.float32), np.asarray(knot, np.float32)


def basis_dim(cfg: ModelConfig) -> int:
    return sum(r + 1 for r in fac_resolutions(cfg))


def init_factored_params(key: jax.Array, cfg: ModelConfig) -> Params:
    """Lines N(0, fac_init_scale); tiny heads He-init. With ~2 nonzero
    hat weights per level per row, enc_a std ~ sqrt(0.8 * levels) *
    scale; the default 0.25 puts the 3-way product's std near 0.2 at
    6 levels, keeping the sigma head's He-init assumptions roughly
    honest."""
    kl, kh = jax.random.split(key)
    lines = cfg.fac_init_scale * jax.random.normal(
        kl, (3, basis_dim(cfg), cfg.fac_comps), jnp.float32
    )
    params: Params = {"lines": lines}
    params.update(init_tiny_heads(kh, cfg.fac_comps, cfg))
    return params


def hat_weights(
    u_axis: jnp.ndarray, cfg: ModelConfig
) -> jnp.ndarray:
    """(N,) normalized coords in [0,1] -> (N, sumR) hat-basis weights.

    Column j is max(0, 1 - |u * res[j] - knot[j]|): exactly the two
    surrounding knots of each level are nonzero — linear interpolation
    weights for every level at once. f32 arithmetic (bf16 knot
    positions at R=512 would quantize the cell coordinate); the caller
    casts AFTER for the matmul."""
    res_c, knot_c = knot_constants(cfg)
    pos = u_axis[:, None] * jnp.asarray(res_c)[None, :]
    return jax.nn.relu(1.0 - jnp.abs(pos - jnp.asarray(knot_c)[None, :]))


def factored_encode(
    lines: jnp.ndarray, points: jnp.ndarray, cfg: ModelConfig, dtype=None
) -> jnp.ndarray:
    """(..., 3) world points -> (..., C) CP-product features.

    All tensors are (N, sumR) / (N, C) — no narrow minor dims
    materialize."""
    lead = points.shape[:-1]
    p = points.reshape(-1, 3)
    u = jnp.clip((p + cfg.fac_aabb) / (2.0 * cfg.fac_aabb), 0.0, 1.0)
    mm = dtype if dtype is not None else jnp.float32
    enc = None
    for a in range(3):
        w = hat_weights(u[:, a], cfg).astype(mm)
        feat = w @ lines[a].astype(mm)  # (N, C)
        enc = feat if enc is None else enc * feat
    return enc.reshape(*lead, cfg.fac_comps)


def apply_factored(
    params: Params,
    points: jnp.ndarray,
    viewdirs: jnp.ndarray,
    cfg: ModelConfig,
    dtype=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Same contract as mlp.apply_nerf / hashgrid.apply_hashgrid:
    (sigma_raw (...,), rgb_raw (..., 3)) before activations."""
    enc = factored_encode(params["lines"], points, cfg, dtype)
    return apply_tiny_heads(params, enc, viewdirs, cfg, dtype)
