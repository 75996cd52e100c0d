"""Camera-ray generation, vectorized and jit-friendly.

Vectorized redesign of the reference's scalar CPU geometry
(src/ray_sampling.rs:7-178): instead of rotating every sample point by
yaw-then-pitch (the TODO the reference itself flags at
src/ray_sampling.rs:95,143), we rotate the camera once — build a 3x3
pose rotation, transform canonical ray origins/directions, and sample
points later as ``o + t*d``. All functions are pure, batched over
pixels/views, and trace to a single XLA program.

Conventions (verified against the reference's math):
  * yaw(theta)   == rotation about +Y: Ry (src/ray_sampling.rs:20-26)
  * pitch(theta) == rotation about +X: Rx (src/ray_sampling.rs:32-69 —
    the Rodrigues construction about u = normalize(cross(view, up)) =
    [-1,0,0] applied column-major collapses to Rx(theta))
  * point rotation order is yaw then pitch, so the camera pose is
    R = Rx(pitch) @ Ry(yaw).
"""

from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import CameraConfig


def rotation_yaw(angle: jnp.ndarray) -> jnp.ndarray:
    """Rotation about +Y (reference rotateYaw, src/ray_sampling.rs:20-26).

    Batched: ``angle`` of shape (...,) -> (..., 3, 3).
    """
    angle = jnp.asarray(angle)
    c, s = jnp.cos(angle), jnp.sin(angle)
    z, o = jnp.zeros_like(c), jnp.ones_like(c)
    rows = jnp.stack(
        [
            jnp.stack([c, z, s], axis=-1),
            jnp.stack([z, o, z], axis=-1),
            jnp.stack([-s, z, c], axis=-1),
        ],
        axis=-2,
    )
    return rows


def rotation_pitch(angle: jnp.ndarray) -> jnp.ndarray:
    """Rotation about +X (reference rotatePitch, src/ray_sampling.rs:32-69)."""
    angle = jnp.asarray(angle)
    c, s = jnp.cos(angle), jnp.sin(angle)
    z, o = jnp.zeros_like(c), jnp.ones_like(c)
    rows = jnp.stack(
        [
            jnp.stack([o, z, z], axis=-1),
            jnp.stack([z, c, -s], axis=-1),
            jnp.stack([z, s, c], axis=-1),
        ],
        axis=-2,
    )
    return rows


def pose_from_yaw_pitch(yaw: jnp.ndarray, pitch: jnp.ndarray) -> jnp.ndarray:
    """World-from-canonical rotation for a (yaw, pitch) view angle.

    The reference rotates sample points yaw-then-pitch
    (src/ray_sampling.rs:130-131); composing once gives
    R = Rx(pitch) @ Ry(yaw). Batched over leading dims. Full f32
    precision — tiny 3x3 composition, and the GPU's default float32
    matmul (TF32, 10-bit mantissa) would denormalize the rotation.
    """
    return jnp.einsum(
        "...ij,...jk->...ik",
        rotation_pitch(pitch),
        rotation_yaw(yaw),
        precision=jax.lax.Precision.HIGHEST,
    )


def view_angle_grid(num_views: int) -> jnp.ndarray:
    """Hemisphere view-angle grid (reference get_view_angles,
    src/image_loading.rs:67-80).

    ``2*num_views`` yaw steps x ``num_views+1`` pitch steps in increments
    of pi/num_views; num_views=6 -> 84 views, matching view_end=84
    (src/cli.rs:25-26). Returns (2*num_views*(num_views+1), 2) array of
    (yaw, pitch) pairs in the reference's enumeration order
    (yaw-major, pitch inner).
    """
    step = math.pi / num_views
    yaw = jnp.arange(2 * num_views) * step
    pitch = jnp.arange(num_views + 1) * step
    yy, pp = jnp.meshgrid(yaw, pitch, indexing="ij")
    return jnp.stack([yy.reshape(-1), pp.reshape(-1)], axis=-1)


def spherical_render_path(num_frames: int = 40, pitch: float = math.pi / 6) -> jnp.ndarray:
    """Camera path for the novel-view render sweep (BASELINE config 4):
    ``num_frames`` yaw steps around the full circle at a fixed pitch.

    The reference's (commented) sweep advances the angle with the
    iteration counter (src/display.rs:64-65); here it is an explicit
    path of (yaw, pitch) pairs.
    """
    yaw = jnp.linspace(0.0, 2.0 * math.pi, num_frames, endpoint=False)
    return jnp.stack([yaw, jnp.full_like(yaw, pitch)], axis=-1)


def _canonical_frame(camera: CameraConfig):
    """view / left / up unit vectors of the canonical camera
    (src/ray_sampling.rs:84-86)."""
    origin = jnp.asarray(camera.origin, jnp.float32)
    at = jnp.asarray(camera.at, jnp.float32)
    up = jnp.asarray(camera.up, jnp.float32)
    view = at - origin
    view = view / jnp.linalg.norm(view)
    left = jnp.cross(view, up)
    left = left / jnp.linalg.norm(left)
    return origin, view, left, up


def pixel_directions(
    coords_xy: jnp.ndarray, camera: CameraConfig
) -> jnp.ndarray:
    """Canonical (unrotated) unit ray directions for pixel coords.

    Vectorized grid version of the reference's per-pixel
    ``screen_to_world`` (src/ray_sampling.rs:79-93): a point on the
    near ("hither") plane offset by the half-FOV extent, normalized.

    Args:
      coords_xy: (..., 2) float or int pixel coordinates as (x, y).
      camera: intrinsics.
    Returns:
      (..., 3) unit directions in the canonical camera frame.
    """
    coords_xy = jnp.asarray(coords_xy, jnp.float32)
    _, view, left, up = _canonical_frame(camera)
    off = math.tan(camera.fov / 2.0) * camera.near
    x = coords_xy[..., 0]
    y = coords_xy[..., 1]
    offset_left = off - 2.0 * off * x / camera.width
    offset_up = off - 2.0 * off * y / camera.height
    to = (
        camera.near * view
        + offset_left[..., None] * left
        + offset_up[..., None] * up
    )
    return to / jnp.linalg.norm(to, axis=-1, keepdims=True)


def rays_for_coords(
    coords_xy: jnp.ndarray,
    pose: jnp.ndarray,
    camera: CameraConfig,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Camera rays for arbitrary pixel coordinates under a pose rotation.

    Rotates origin and direction ONCE (fixing the reference's per-point
    rotation TODO, src/ray_sampling.rs:95): since the reference computes
    R @ (from + t*d) and samples later use o' + t*d' with o' = R@from,
    d' = R@d, world-space sample points are bitwise-equivalent up to
    float reassociation.

    Args:
      coords_xy: (..., 2) pixel (x, y).
      pose: (3, 3) or broadcastable (..., 3, 3) world-from-canonical
        rotation (see pose_from_yaw_pitch), or None for canonical.
    Returns:
      origins (..., 3), directions (..., 3) — directions unit-norm.
    """
    dirs = pixel_directions(coords_xy, camera)
    origin = jnp.asarray(camera.origin, jnp.float32)
    if pose is None:
        origins = jnp.broadcast_to(origin, dirs.shape)
        return origins, dirs
    pose = jnp.asarray(pose, jnp.float32)
    hi = jax.lax.Precision.HIGHEST
    dirs = jnp.einsum("...ij,...j->...i", pose, dirs, precision=hi)
    origins = jnp.broadcast_to(
        jnp.einsum("...ij,j->...i", pose, origin, precision=hi), dirs.shape
    )
    return origins, dirs


def ray_grid(
    pose: jnp.ndarray, camera: CameraConfig
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Full-frame rays: (H, W, 3) origins and directions for one pose.

    The grid equivalent of enumerating all screen coords
    (src/display.rs:58-62) — generated on-device from iota, no host
    arrays.
    """
    x = jnp.arange(camera.width, dtype=jnp.float32)
    y = jnp.arange(camera.height, dtype=jnp.float32)
    xx, yy = jnp.meshgrid(x, y, indexing="xy")
    coords = jnp.stack([xx, yy], axis=-1)  # (H, W, 2)
    return rays_for_coords(coords, pose, camera)


def rays_from_c2w(
    coords_xy: jnp.ndarray,
    c2w: jnp.ndarray,
    height: int,
    width: int,
    focal: float,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Rays under the Blender/NeRF ``transforms.json`` convention.

    Standard synthetic-NeRF camera: pixel (x, y) maps to camera-space
    direction [(x-W/2)/f, -(y-H/2)/f, -1], rotated by c2w[:3,:3] with
    origin c2w[:3,3]. (Capability addition over the reference, which
    only supports its fixed look-at camera; needed for the 800x800 lego
    configs in BASELINE.json.)
    """
    coords_xy = jnp.asarray(coords_xy, jnp.float32)
    c2w = jnp.asarray(c2w, jnp.float32)
    x = coords_xy[..., 0]
    y = coords_xy[..., 1]
    dirs = jnp.stack(
        [
            (x - width * 0.5) / focal,
            -(y - height * 0.5) / focal,
            -jnp.ones_like(x),
        ],
        axis=-1,
    )
    world_dirs = jnp.einsum(
        "...ij,...j->...i", c2w[..., :3, :3], dirs,
        precision=jax.lax.Precision.HIGHEST,
    )
    origins = jnp.broadcast_to(c2w[..., :3, 3], world_dirs.shape)
    return origins, world_dirs


def ray_grid_c2w(
    c2w: jnp.ndarray, height: int, width: int, focal: float
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Full-frame Blender-convention rays for one 3x4/4x4 pose."""
    x = jnp.arange(width, dtype=jnp.float32)
    y = jnp.arange(height, dtype=jnp.float32)
    xx, yy = jnp.meshgrid(x, y, indexing="xy")
    coords = jnp.stack([xx, yy], axis=-1)
    return rays_from_c2w(coords, c2w, height, width, focal)


def ndc_rays(
    origins: jnp.ndarray,
    dirs: jnp.ndarray,
    camera: CameraConfig,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Reparameterize world rays into normalized device coordinates
    (NeRF paper appendix C, eqs. 25-26 — the forward-facing / LLFF
    mode). Assumes the forward-facing convention: cameras near the
    world origin looking toward -z, scene content beyond the
    ``camera.ndc_near`` plane.

    Each world ray maps to an NDC ray such that o' + s d' for
    s in [0, 1] sweeps the world ray from z = -ndc_near out to
    z = -inf; NDC z = 1 + 2 near/z is DISPARITY-linear, so uniform
    samples in s match the paper's LLFF sampling. x/y land in [-1, 1]
    across the frustum. Downstream (sampling with near=0, far=1, PE,
    kernels, compositing over NDC deltas) is unchanged — the field is
    simply learned in NDC coordinates, exactly as in the paper.

    One deliberate difference from the paper's LLFF code: the radiance
    head is conditioned on the normalized NDC direction rather than the
    world direction (the warp happens before view dirs are derived).
    The NDC map is a bijection on frustum rays, so this is an
    equivalent — just differently warped — view parameterization.
    """
    focal = camera.focal
    if focal is None:
        focal = 0.5 * camera.width / math.tan(0.5 * camera.fov)
    near = camera.ndc_near
    # slide origins to the z = -near plane along the ray
    t = -(near + origins[..., 2]) / dirs[..., 2]
    o = origins + t[..., None] * dirs
    sx = -focal / (0.5 * camera.width)
    sy = -focal / (0.5 * camera.height)
    o_ndc = jnp.stack([
        sx * o[..., 0] / o[..., 2],
        sy * o[..., 1] / o[..., 2],
        1.0 + 2.0 * near / o[..., 2],
    ], axis=-1)
    d_ndc = jnp.stack([
        sx * (dirs[..., 0] / dirs[..., 2] - o[..., 0] / o[..., 2]),
        sy * (dirs[..., 1] / dirs[..., 2] - o[..., 1] / o[..., 2]),
        -2.0 * near / o[..., 2],
    ], axis=-1)
    return o_ndc, d_ndc


def maybe_ndc(
    origins: jnp.ndarray, dirs: jnp.ndarray, camera: CameraConfig
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Apply the NDC reparameterization when the camera asks for it —
    the single hook every ray producer (batch samplers, view_rays,
    render sweeps) routes through."""
    if getattr(camera, "ndc", False):
        return ndc_rays(origins, dirs, camera)
    return origins, dirs
