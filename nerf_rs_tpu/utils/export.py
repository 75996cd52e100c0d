"""Trained-field export: sigma grid (.npz) and colored point cloud
(.ply).

The reference has no export path at all (its only field output is the
live minifb window, src/display.rs); production NeRF stacks ship one.
The sampler reuses the occupancy grid's layout: activations kept 3-D,
x-slab chunking to bound device memory at large res.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ModelConfig
from ..models.mlp import Params, apply_nerf


@partial(jax.jit, static_argnames=("model_cfg", "res", "aabb", "dtype"))
def _slab_sigma_rgb(
    params: Params,
    xs: jnp.ndarray,  # (B,) x-coordinates of this slab
    model_cfg: ModelConfig,
    res: int,
    aabb: float,
    dtype=jnp.bfloat16,
):
    """sigma and RGB on the (B, res, res) slab of grid cell centers.
    RGB uses a fixed +z viewdir (sigma is view-independent; the color
    is the +z-facing radiance, adequate for inspection exports)."""
    cell = 2.0 * aabb / res
    c1d = jnp.linspace(-aabb + cell / 2.0, aabb - cell / 2.0, res)
    gx, gy, gz = jnp.meshgrid(xs, c1d, c1d, indexing="ij")
    pts = jnp.stack([gx, gy, gz], axis=-1).reshape(xs.shape[0] * res, res, 3)
    vd = jnp.zeros_like(pts).at[..., 2].set(1.0)
    sigma, rgb = apply_nerf(params, pts, vd, model_cfg, dtype)
    B = xs.shape[0]
    return (sigma.reshape(B, res, res),
            rgb.reshape(B, res, res, 3))


def sample_density_grid(
    params: Params,
    model_cfg: ModelConfig,
    res: int = 128,
    aabb: float = 1.6,
    dtype=jnp.bfloat16,
    slab: int = 16,
):
    """Evaluate sigma and RGB at the centers of a res^3 grid over
    [-aabb, aabb]^3. Returns (sigma (res,res,res), rgb (res,res,res,3))
    as host numpy arrays; chunked in x-slabs of ``slab`` planes."""
    cell = 2.0 * aabb / res
    c1d = np.linspace(-aabb + cell / 2.0, aabb - cell / 2.0, res,
                      dtype=np.float32)
    sig_out = np.empty((res, res, res), np.float32)
    rgb_out = np.empty((res, res, res, 3), np.float32)
    for x0 in range(0, res, slab):
        xs = jnp.asarray(c1d[x0:x0 + slab])
        s, c = _slab_sigma_rgb(params, xs, model_cfg, res, aabb, dtype)
        sig_out[x0:x0 + slab] = np.asarray(s, np.float32)
        rgb_out[x0:x0 + slab] = np.asarray(c, np.float32)
    return sig_out, rgb_out


def save_npz(path: str, sigma: np.ndarray, rgb: np.ndarray, aabb: float):
    np.savez_compressed(path, sigma=sigma, rgb=rgb,
                        aabb=np.float32(aabb))


def occupied_points(
    sigma: np.ndarray, rgb: np.ndarray, aabb: float, threshold: float
):
    """Centers + colors of cells with sigma > threshold.
    Returns (xyz (N,3) f32, rgb8 (N,3) uint8)."""
    res = sigma.shape[0]
    cell = 2.0 * aabb / res
    c1d = np.linspace(-aabb + cell / 2.0, aabb - cell / 2.0, res,
                      dtype=np.float32)
    ii, jj, kk = np.nonzero(sigma > threshold)
    xyz = np.stack([c1d[ii], c1d[jj], c1d[kk]], axis=-1)
    rgb8 = np.clip(rgb[ii, jj, kk] * 255.0, 0, 255).astype(np.uint8)
    return xyz, rgb8


def save_ply(path: str, xyz: np.ndarray, rgb8: np.ndarray):
    """ASCII PLY point cloud (xyz + uchar RGB) — loads in MeshLab,
    Blender, Open3D."""
    assert xyz.shape[0] == rgb8.shape[0]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {xyz.shape[0]}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\n"
                "property uchar blue\nend_header\n")
        for (x, y, z), (r, g, b) in zip(xyz, rgb8):
            f.write(f"{x:.5f} {y:.5f} {z:.5f} {r} {g} {b}\n")
