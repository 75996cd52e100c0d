"""Instant-NGP radiance field: multiresolution hash encoding + tiny
MLPs (arXiv 2201.05989), as a second architecture family next to the
paper NeRF (models/mlp.py). The reference has a single fixed MLP
(src/model.rs:45-93); this is the modern time-to-quality architecture.

Design notes:
  * All level resolutions, table offsets, and the dense-vs-hashed
    decision per level are STATIC (computed from the frozen ModelConfig
    at trace time) — the jitted program contains no data-dependent
    control flow.
  * The L per-level tables live in ONE (L*T, F) leaf so the encoding is
    a single `jnp.take` over a flat axis (one fused gather; its
    transpose is one scatter-add into the same leaf for the backward).
  * Corner weights/indices are built in (N, L, 8[, 3]) layouts and
    contracted with an einsum; the tiny (N, L, 8, F=2) gather result is
    consumed immediately by the reduction, so XLA keeps it in the fused
    loop rather than materializing it in device memory.
  * Coarse levels where a dense grid fits the table ((N_l+1)^3 <= T)
    index directly (collision-free), like the CUDA original; finer
    levels use the 3-prime spatial hash with uint32 wraparound.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ModelConfig
from .encoding import posenc, posenc_dim
from .mlp import _init_linear, dense

Params = Dict[str, Any]

# instant-ngp's spatial-hash primes (pi_1 = 1 keeps x-major dense
# locality; the uint32 products wrap, which is part of the hash)
_PRIMES = (1, 2654435761, 805459861)


def level_resolutions(cfg: ModelConfig) -> List[int]:
    """N_l = floor(N_min * b^l), b chosen so level L-1 hits N_max
    (paper eq. 2-3)."""
    L = cfg.hash_levels
    if L == 1:
        return [cfg.hash_base_res]
    b = math.exp(
        (math.log(cfg.hash_max_res) - math.log(cfg.hash_base_res)) / (L - 1)
    )
    return [int(math.floor(cfg.hash_base_res * (b ** l))) for l in range(L)]


def init_tiny_heads(key: jax.Array, enc_dim: int, cfg: ModelConfig) -> Params:
    """He-init tiny sigma/color MLPs shared by the grid-encoding
    families (hashgrid, factored): enc -> W -> 1+G sigma net, then
    (G [, PE(dir)]) -> W -> W -> 3 color net."""
    W = cfg.hash_mlp_width
    G = cfg.hash_geo_feats
    dir_dim = posenc_dim(3, cfg.dir_enc_levels, cfg.include_input_in_enc)
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    params: Params = {
        "sigma1": _init_linear(k1, enc_dim, W),
        "sigma2": _init_linear(k2, W, 1 + G),
    }
    if cfg.use_viewdirs:
        params["color1"] = _init_linear(k3, G + dir_dim, W)
    else:
        params["color1"] = _init_linear(k3, G, W)
    params["color2"] = _init_linear(k4, W, W)
    params["rgb"] = _init_linear(k5, W, 3)
    return params


def apply_tiny_heads(
    params: Params,
    enc: jnp.ndarray,
    viewdirs: jnp.ndarray,
    cfg: ModelConfig,
    dtype=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """enc (..., enc_dim) -> (sigma_raw (...,), rgb_raw (..., 3)),
    both f32, BEFORE activations (the apply_nerf dispatch applies
    cfg.sigma_activation / rgb sigmoid so noise/compat semantics stay
    in one place)."""
    if dtype is not None and dtype != jnp.float32:
        enc = enc.astype(dtype)
    h = jax.nn.relu(dense(enc, params["sigma1"], dtype))
    out = dense(h, params["sigma2"], dtype)
    sigma_raw = out[..., 0].astype(jnp.float32)
    geo = out[..., 1:]
    if cfg.use_viewdirs:
        d = posenc(viewdirs, cfg.dir_enc_levels, cfg.include_input_in_enc)
        d = jnp.broadcast_to(d, geo.shape[:-1] + (d.shape[-1],))
        if dtype is not None and dtype != jnp.float32:
            d = d.astype(dtype)
        hc = jnp.concatenate([geo, d], axis=-1)
    else:
        hc = geo
    hc = jax.nn.relu(dense(hc, params["color1"], dtype))
    hc = jax.nn.relu(dense(hc, params["color2"], dtype))
    rgb_raw = dense(hc, params["rgb"], dtype).astype(jnp.float32)
    return sigma_raw, rgb_raw


def brick_table_entries(cfg: ModelConfig) -> int:
    """Bricks per level: same PARAMETER budget as the flat layout —
    each brick row holds 64 vertices x F floats, so T_b = T*F/128."""
    T = 1 << cfg.hash_table_log2
    F = cfg.hash_features
    return max(1, (T * F) // 128)


def init_hash_params(key: jax.Array, cfg: ModelConfig) -> Params:
    """Tables U(-1e-4, 1e-4) (paper §4); tiny MLPs He-init."""
    L, F = cfg.hash_levels, cfg.hash_features
    T = 1 << cfg.hash_table_log2
    kt, kh = jax.random.split(key)
    if cfg.hash_brick:
        Tb = brick_table_entries(cfg)
        table = jax.random.uniform(
            kt, (L * Tb, 128), jnp.float32, -1e-4, 1e-4)
    else:
        table = jax.random.uniform(
            kt, (L * T, F), jnp.float32, -1e-4, 1e-4)
    params: Params = {"table": table}
    params.update(init_tiny_heads(kh, L * F, cfg))
    return params


def hash_encode(
    table: jnp.ndarray, points: jnp.ndarray, cfg: ModelConfig
) -> jnp.ndarray:
    """(..., 3) world points -> (..., L*F) multiresolution features.

    Trilinear interpolation of the 8 surrounding grid vertices at every
    level; vertex features come from a dense index when the level's
    grid fits the table, else the spatial hash.

    Layout: every tensor this builds is (N, K=L*8*F) — minor dim 256
    at the defaults — with all per-(level, corner, feature) structure
    folded into constant (K,) row vectors, so no narrow minor dims
    materialize. The flat scalar-gather indices, trilinear weights, and
    gathered values all live at (N, K); the corner reduction is one
    constant 0/1 (K, L*F) matmul.
    """
    L, F = cfg.hash_levels, cfg.hash_features
    T = 1 << cfg.hash_table_log2
    lead = points.shape[:-1]
    p = points.reshape(-1, 3)
    n = p.shape[0]
    # normalize to [0, 1] over the AABB; clip so out-of-box samples
    # (possible with blender far planes) land on the boundary cells
    u = jnp.clip((p + cfg.hash_aabb) / (2.0 * cfg.hash_aabb), 0.0, 1.0)

    # column j of the (N, K) layout covers (level, corner, feature) =
    # (j // 8F, (j // F) % 8, j % F) — the same row-major order as a
    # (L, 8, F) reshape, so checkpoints are layout-stable
    res_l = level_resolutions(cfg)
    K = L * 8 * F
    j = np.arange(K)
    lv, cn, ft = j // (8 * F), (j // F) % 8, j % F
    corners = np.asarray(
        [[a, b, c] for a in (0, 1) for b in (0, 1) for c in (0, 1)],
        np.int64,
    )
    cbits = corners[cn]  # (K, 3) corner offsets per column
    res_c = jnp.asarray(np.asarray(res_l, np.float32)[lv])  # (K,)
    rp1_c = jnp.asarray((np.asarray(res_l, np.int64) + 1)[lv]
                        .astype(np.int32))
    dense_c = jnp.asarray(
        np.asarray([(r + 1) ** 3 <= T for r in res_l])[lv])

    # per-axis corner coords + interp factors, all (N, K)
    ints, facs = [], []
    for a in range(3):
        scaled = u[:, a:a + 1] * res_c[None, :]
        ia = jnp.floor(scaled)
        fr = scaled - ia
        ints.append(ia.astype(jnp.int32)
                    + jnp.asarray(cbits[:, a].astype(np.int32))[None, :])
        m = jnp.asarray(cbits[:, a].astype(np.float32))[None, :]
        facs.append(m * fr + (1.0 - m) * (1.0 - fr))
    wts = facs[0] * facs[1] * facs[2]  # trilinear weights (N, K)

    # both index formulas over the full (N, K); a constant column mask
    # picks dense (collision-free, grid fits the table) vs hashed
    cx, cy, cz = ints
    flat_dense = cx + rp1_c[None, :] * (cy + rp1_c[None, :] * cz)
    ux, uy, uz = (c.astype(jnp.uint32) for c in ints)
    flat_hash = (
        ux * jnp.uint32(_PRIMES[0])
        ^ uy * jnp.uint32(_PRIMES[1])
        ^ uz * jnp.uint32(_PRIMES[2])
    ) & jnp.uint32(T - 1)
    flat = jnp.where(dense_c[None, :], flat_dense,
                     flat_hash.astype(jnp.int32))
    fidx = ((flat + jnp.asarray((lv * T).astype(np.int32))[None, :]) * F
            + jnp.asarray(ft.astype(np.int32))[None, :])

    vals = jnp.take(table.reshape(-1), fidx.reshape(-1),
                    axis=0).reshape(n, K)
    # corner reduction as a constant 0/1 matmul: (l,c,f) -> (l,f)
    reduce_m = np.zeros((K, L * F), np.float32)
    reduce_m[j, lv * F + ft] = 1.0
    enc = (vals * wts) @ jnp.asarray(reduce_m)  # (N, L*F)
    return enc.reshape(*lead, L * F)


# brick_encode chunk size: bounds the (chunk*L, 128) f32 live set
_BRICK_CHUNK = 1 << 17


def brick_encode(
    table: jnp.ndarray, points: jnp.ndarray, cfg: ModelConfig
) -> jnp.ndarray:
    """Brick-layout multiresolution hash encoding: (..., 3) -> (..., L*F).

    A redesign of the Instant-NGP table around contiguous row
    gathers: the flat layout gathers 8 B corner pairs, while here each
    table entry is
    a 4^3-vertex brick covering 3^3 cells of the level grid, stored as
    one (128,) row (64 vertices x F=2). Any sample's 8 trilinear
    corners lie inside ONE brick (vertex v in [0, r], brick v//3,
    intra-brick offset v%3 + {0,1} <= 3), so a (point, level) costs a
    single aligned row gather; corners are then selected in-register
    by two weighted lane reductions. Vertices on multiple-of-3 planes
    are duplicated across bricks ((4/3)^3 ~ 2.4x vertex duplication at
    EQUAL parameter count — T_b = T*F/128 entries, so capacity shifts
    from hash slots to duplicated storage; the hash already collides,
    this trades collision rate for access granularity).

    Same dense-when-it-fits rule as hash_encode, applied to the brick
    grid. Backward: jnp.take's VJP scatter-adds whole rows — the same
    row granularity the forward pays.
    """
    L, F = cfg.hash_levels, cfg.hash_features
    if F != 2:
        raise ValueError("brick layout packs 64 vertices x F into one "
                         f"128-wide row: needs hash_features=2, got {F}")
    Tb = brick_table_entries(cfg)
    lead = points.shape[:-1]
    p = points.reshape(-1, 3)
    n = p.shape[0]
    # the gathered rows + selection masks are (n*L, 128) f32 — ~8 KB
    # per point at L=16. Chunk big batches (lax.map = sequential
    # launches) so a flagship-shape call (~786k points) peaks at
    # ~1.3 GB instead of ~19 GB of live intermediates.
    if n > _BRICK_CHUNK:
        k = -(-n // _BRICK_CHUNK)
        npad = k * _BRICK_CHUNK
        p_pad = jnp.concatenate(
            [p, jnp.zeros((npad - n, 3), p.dtype)]) if npad != n else p
        chunks = p_pad.reshape(k, _BRICK_CHUNK, 3)
        enc = jax.lax.map(lambda q: brick_encode(table, q, cfg), chunks)
        return enc.reshape(npad, L * F)[:n].reshape(*lead, L * F)
    u = jnp.clip((p + cfg.hash_aabb) / (2.0 * cfg.hash_aabb), 0.0, 1.0)

    res_l = level_resolutions(cfg)
    res_f = jnp.asarray(np.asarray(res_l, np.float32))  # (L,)
    res_i = jnp.asarray(np.asarray(res_l, np.int32))
    scaled = u[:, None, :] * res_f[None, :, None]  # (N, L, 3)
    v0 = jnp.clip(jnp.floor(scaled).astype(jnp.int32), 0,
                  res_i[None, :, None] - 1)
    fr = scaled - v0.astype(jnp.float32)  # in [0, 1] (1 at the far clip)
    b = v0 // 3
    o = v0 - 3 * b  # intra-brick vertex offset, {0, 1, 2}

    nb_l = [(r - 1) // 3 + 1 for r in res_l]  # bricks per axis
    dense_l = [nb ** 3 <= Tb for nb in nb_l]
    nb = jnp.asarray(np.asarray(nb_l, np.int32))[None, :]  # (1, L)
    dense = jnp.asarray(np.asarray(dense_l))[None, :]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]  # (N, L)
    flat_dense = bx + nb * (by + nb * bz)
    ux, uy, uz = (c.astype(jnp.uint32) for c in (bx, by, bz))
    flat_hash = (
        ux * jnp.uint32(_PRIMES[0])
        ^ uy * jnp.uint32(_PRIMES[1])
        ^ uz * jnp.uint32(_PRIMES[2])
    ) & jnp.uint32(Tb - 1)
    flat = jnp.where(dense, flat_dense, flat_hash.astype(jnp.int32))
    rows_idx = flat + jnp.asarray(
        np.arange(L, dtype=np.int32) * Tb)[None, :]
    rows = jnp.take(table, rows_idx.reshape(-1), axis=0)  # (N*L, 128)

    # two weighted lane reductions (one per feature): M_f = sum_c w_c *
    # onehot(lane_c*F + f) is built elementwise and consumed by the
    # same pass over `rows` — no (N, L, 8, ...) tiny-minor intermediates,
    # everything stays (N*L, 128)
    iota = jax.lax.broadcasted_iota(jnp.int32, (1, 128), 1)
    ofs = [o[..., a].reshape(-1) for a in range(3)]  # each (N*L,)
    frs = [fr[..., a].reshape(-1) for a in range(3)]
    M = [jnp.zeros((n * L, 128), jnp.float32) for _ in range(F)]
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                lane = (((ofs[0] + dx) * 4 + (ofs[1] + dy)) * 4
                        + (ofs[2] + dz)) * F  # (N*L,)
                w = ((frs[0] if dx else 1.0 - frs[0])
                     * (frs[1] if dy else 1.0 - frs[1])
                     * (frs[2] if dz else 1.0 - frs[2]))  # (N*L,)
                for f in range(F):
                    M[f] = M[f] + jnp.where(
                        iota == (lane + f)[:, None], w[:, None], 0.0)
    enc_f = [jnp.sum(rows * M[f], axis=-1) for f in range(F)]
    enc = jnp.stack(enc_f, axis=-1).reshape(n, L * F)
    return enc.reshape(*lead, L * F)


def apply_hashgrid(
    params: Params,
    points: jnp.ndarray,
    viewdirs: jnp.ndarray,
    cfg: ModelConfig,
    dtype=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Evaluate the hash-grid field; same contract as mlp.apply_nerf:
    returns (sigma_raw (...,), rgb_raw (..., 3)) BEFORE activations —
    the caller (mlp.apply_nerf dispatch) applies cfg.sigma_activation /
    rgb sigmoid so noise/compat semantics stay in one place."""
    encode = brick_encode if cfg.hash_brick else hash_encode
    enc = encode(params["table"], points, cfg)
    return apply_tiny_heads(params, enc, viewdirs, cfg, dtype)
