"""Procedural lego-class Blender scene: analytic SDF geometry +
high-frequency texture, rendered to the standard ``transforms_{split}.json``
layout.

BASELINE.json's quality metric of record is "test PSNR on lego" at
800x800, but the real lego dataset cannot be fetched in a zero-egress
environment. This module generates a scene of comparable character —
sharp multi-primitive geometry (studded slab, torus, twisted box,
sphere) with ~12 rad/unit color texture on a white background, shot
from an upper-hemisphere camera ring at the lego camera distance — so
BASELINE config 3 (64+128 hierarchical) has a reproducible 800x800
benchmark scene with honest held-out splits.

Gold frames are integrated directly from the analytic field (512
uniform samples/ray, the same compositing math as ops/render) — the
scene is DEFINED by this integral, so the trained NeRF's test PSNR
measures pure model fit, not renderer mismatch.
"""

from __future__ import annotations

import json
import math
import os
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# lego-like camera geometry (NeRF synthetic: radius ~4.03, fov ~0.69)
CAMERA_RADIUS = 4.0311
CAMERA_ANGLE_X = 0.6911


def _sd_sphere(p, c, r):
    return jnp.linalg.norm(p - jnp.asarray(c), axis=-1) - r


def _sd_box(p, c, half):
    q = jnp.abs(p - jnp.asarray(c)) - jnp.asarray(half)
    return jnp.linalg.norm(jnp.maximum(q, 0.0), axis=-1) + jnp.minimum(
        jnp.max(q, axis=-1), 0.0
    )


def _sd_torus(p, c, R, r):
    q = p - jnp.asarray(c)
    ring = jnp.sqrt(q[..., 0] ** 2 + q[..., 1] ** 2) - R
    return jnp.sqrt(ring**2 + q[..., 2] ** 2) - r


def _twist(p, k):
    """Rotate xy by k*z — the twisted-box high-frequency geometry."""
    cz = jnp.cos(k * p[..., 2])
    sz = jnp.sin(k * p[..., 2])
    x = cz * p[..., 0] - sz * p[..., 1]
    y = sz * p[..., 0] + cz * p[..., 1]
    return jnp.stack([x, y, p[..., 2]], axis=-1)


def field(points: jnp.ndarray, sharpness: float = 250.0
          ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Analytic (sigma, rgb) at world ``points`` (..., 3); z is up.

    sigma = 60 * sigmoid(-sdf * sharpness): razor-thin soft surfaces.
    Colors: per-primitive palette modulated by 3-D sinusoidal texture
    (~12 rad/unit) and an 8x checker on the slab.
    """
    p = points
    # primitives (units chosen to fill roughly the lego bounding box)
    slab = _sd_box(p, (0.0, 0.0, -0.15), (1.1, 1.1, 0.1))
    torus = _sd_torus(p, (0.0, 0.0, 0.35), 0.62, 0.16)
    ball = _sd_sphere(p, (0.0, 0.0, 0.78), 0.26)
    tbox = _sd_box(_twist(p - jnp.asarray((0.55, -0.5, 0.0)), 5.0),
                   (0.0, 0.0, 0.3), (0.16, 0.16, 0.34))
    # 4x4 stud grid on the slab
    gx = (jnp.round((p[..., 0] + 0.75) / 0.5) * 0.5 - 0.75).clip(-0.75, 0.75)
    gy = (jnp.round((p[..., 1] + 0.75) / 0.5) * 0.5 - 0.75).clip(-0.75, 0.75)
    stud_c = jnp.stack([gx, gy, jnp.full_like(gx, 0.0)], axis=-1)
    studs = jnp.linalg.norm(
        jnp.stack([p[..., 0] - gx, p[..., 1] - gy,
                   (p[..., 2] - 0.06) * 1.4], axis=-1), axis=-1
    ) - 0.09
    del stud_c

    sdfs = jnp.stack([slab, torus, ball, tbox, studs], axis=-1)
    sdf = jnp.min(sdfs, axis=-1)
    prim = jnp.argmin(sdfs, axis=-1)
    sigma = 60.0 * jax.nn.sigmoid(-sdf * sharpness)

    palette = jnp.asarray([
        [0.85, 0.78, 0.25],  # slab: lego yellow
        [0.80, 0.15, 0.12],  # torus: red
        [0.15, 0.35, 0.85],  # ball: blue
        [0.15, 0.75, 0.30],  # twisted box: green
        [0.85, 0.45, 0.10],  # studs: orange
    ], jnp.float32)
    base = palette[prim]
    tex = 0.5 + 0.5 * (jnp.sin(12.0 * p[..., 0]) *
                       jnp.sin(12.0 * p[..., 1]) *
                       jnp.sin(12.0 * p[..., 2]))
    checker = 0.5 + 0.5 * jnp.mod(
        jnp.floor(4.0 * p[..., 0]) + jnp.floor(4.0 * p[..., 1]), 2.0
    )
    mod = jnp.where(prim == 0, 0.35 + 0.65 * checker, 0.55 + 0.45 * tex)
    # cheap lambertian-ish shading off the density gradient direction is
    # skipped: colors stay view-independent so any radiance model fits
    rgb = jnp.clip(base * mod[..., None], 0.0, 1.0)
    return sigma, rgb


def _sd_cylinder(p, c, r, h):
    """Capped vertical cylinder: radius r, half-height h."""
    q = p - jnp.asarray(c)
    d_rad = jnp.sqrt(q[..., 0] ** 2 + q[..., 1] ** 2) - r
    d_cap = jnp.abs(q[..., 2]) - h
    d = jnp.stack([d_rad, d_cap], axis=-1)
    return jnp.linalg.norm(jnp.maximum(d, 0.0), axis=-1) + jnp.minimum(
        jnp.max(d, axis=-1), 0.0
    )


def _sd_helix(p, c, R, pitch, r, z_half):
    """Tube of radius r along a vertical helix of radius R and the
    given pitch, clipped to |z - cz| <= z_half. Approximate SDF (exact
    near the surface, which is all a sharpness-250 sigmoid ever sees)."""
    q = p - jnp.asarray(c)
    phase = jnp.arctan2(q[..., 1], q[..., 0])  # [-pi, pi]
    ring = jnp.sqrt(q[..., 0] ** 2 + q[..., 1] ** 2) - R
    # distance along z to the nearest helix branch at this azimuth
    dz = jnp.mod(
        q[..., 2] - pitch * phase / (2.0 * math.pi) + 0.5 * pitch, pitch
    ) - 0.5 * pitch
    d = jnp.sqrt(ring**2 + dz**2) - r
    return jnp.maximum(d, jnp.abs(q[..., 2]) - z_half)


def _sd_cone(p, c, r_base, z_height):
    """Upright cone: base radius r_base at z=cz, apex at cz+z_height
    (approximate SDF — max of radial taper and caps)."""
    q = p - jnp.asarray(c)
    t = jnp.clip(q[..., 2] / z_height, 0.0, 1.0)
    d_rad = jnp.sqrt(q[..., 0] ** 2 + q[..., 1] ** 2) - r_base * (1.0 - t)
    d_cap = jnp.maximum(-q[..., 2], q[..., 2] - z_height)
    return jnp.maximum(d_rad, d_cap)


def _sd_octahedron(p, c, s):
    q = jnp.abs(p - jnp.asarray(c))
    return (q[..., 0] + q[..., 1] + q[..., 2] - s) * 0.57735027


def field_helix(points: jnp.ndarray, sharpness: float = 250.0
                ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Second record scene ("prochelix"): a DIFFERENT geometry family
    (helical tube around a fluted post, perforated base plate, cone,
    octahedron) and a DIFFERENT texture spectrum (azimuthal stripes +
    ~20 rad/unit rings vs the lego scene's 12 rad/unit sinusoid) —
    evidence that the record config isn't tuned to one field's
    statistics (round-2 verdict next #7). Same density law and camera
    layout as ``field``."""
    p = points
    # perforated base plate: box minus a 5x5 grid of drilled holes
    plate = _sd_box(p, (0.0, 0.0, -0.18), (1.05, 1.05, 0.07))
    gx = (jnp.round((p[..., 0] + 0.8) / 0.4) * 0.4 - 0.8).clip(-0.8, 0.8)
    gy = (jnp.round((p[..., 1] + 0.8) / 0.4) * 0.4 - 0.8).clip(-0.8, 0.8)
    hole = jnp.sqrt((p[..., 0] - gx) ** 2 + (p[..., 1] - gy) ** 2) - 0.07
    plate = jnp.maximum(plate, -hole)  # boolean subtraction
    post = _sd_cylinder(p, (0.0, 0.0, 0.35), 0.13, 0.55)
    helix = _sd_helix(p, (0.0, 0.0, 0.35), R=0.38, pitch=0.42, r=0.07,
                      z_half=0.52)
    cone = _sd_cone(p, (-0.62, 0.55, -0.11), 0.30, 0.85)
    octa = _sd_octahedron(p, (0.0, 0.0, 1.10), 0.30)

    sdfs = jnp.stack([plate, post, helix, cone, octa], axis=-1)
    sdf = jnp.min(sdfs, axis=-1)
    prim = jnp.argmin(sdfs, axis=-1)
    sigma = 60.0 * jax.nn.sigmoid(-sdf * sharpness)

    palette = jnp.asarray([
        [0.20, 0.65, 0.65],  # plate: teal
        [0.82, 0.20, 0.62],  # post: magenta
        [0.88, 0.72, 0.20],  # helix: gold
        [0.45, 0.25, 0.75],  # cone: purple
        [0.80, 0.25, 0.20],  # octahedron: crimson
    ], jnp.float32)
    base = palette[prim]
    # texture spectrum distinct from the lego scene: azimuthal stripes
    # riding z, and ~20 rad/unit radial rings on the plate
    az = jnp.arctan2(p[..., 1], p[..., 0])
    stripes = 0.5 + 0.5 * jnp.sin(10.0 * az + 20.0 * p[..., 2])
    rings = 0.5 + 0.5 * jnp.sin(
        20.0 * jnp.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
    )
    mod = jnp.where(prim == 0, 0.35 + 0.65 * rings, 0.50 + 0.50 * stripes)
    rgb = jnp.clip(base * mod[..., None], 0.0, 1.0)
    return sigma, rgb


def field_facing(points: jnp.ndarray, sharpness: float = 250.0
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Forward-facing wrapper of the lego field: content centered at
    world (0, 0, -FACING_DEPTH) viewed by cameras near the origin
    looking down -z (the LLFF/NDC convention, ops/rays.ndc_rays). The
    world->scene map sends camera depth onto the lego field's z-up
    axis, so the cameras see the studded slab face-on with the full
    primitive set in relief."""
    p = points
    scene = jnp.stack(
        [p[..., 0], p[..., 1], -(p[..., 2] + FACING_DEPTH) * 1.4],
        axis=-1,
    )
    return field(scene, sharpness)


FACING_DEPTH = 4.0


def field_360(points: jnp.ndarray, sharpness: float = 50.0
              ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Unbounded 360-degree scene ("proc360") for the mip-NeRF 360
    recipe (--contract + --sampling_space disparity): the lego-class
    central object PLUS surroundings extending to ~40 units — a
    textured ground disc, a ring of pillars at radius ~9, and large
    far spheres at 18-26 units. Geometry scale GROWS with distance on
    purpose: disparity-spaced sampling resolves ~(dg/N) t^2 in metric
    distance, so far primitives are sized several samples wide at their
    range, exactly the regime the contraction allocates capacity for.
    Softer sharpness (50 vs the bounded scenes' 250) keeps every
    surface resolvable at the 1024-sample disparity gold integration.
    """
    p = points
    sigma_c, rgb_c = field(p, sharpness=sharpness * 3.0)  # central object

    # ground disc: thin slab to radius 40, ring-textured
    rad = jnp.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
    ground = jnp.maximum(jnp.abs(p[..., 2] + 0.55) - 0.30, rad - 40.0)
    # pillar ring: 8 cylinders at radius 9 (radius 1.2, height 5),
    # placed by snapping azimuth to the nearest of 8 spokes
    az = jnp.arctan2(p[..., 1], p[..., 0])
    spoke = jnp.round(az / (math.pi / 4.0)) * (math.pi / 4.0)
    cx, cy = 9.0 * jnp.cos(spoke), 9.0 * jnp.sin(spoke)
    d_rad = jnp.sqrt((p[..., 0] - cx) ** 2 + (p[..., 1] - cy) ** 2) - 1.2
    d_cap = jnp.abs(p[..., 2] - 2.2) - 2.8
    pillars = jnp.maximum(d_rad, d_cap)
    # far landmarks: three large spheres at 18-26 units
    s1 = _sd_sphere(p, (18.0, 6.0, 4.0), 5.0)
    s2 = _sd_sphere(p, (-14.0, -17.0, 6.0), 6.0)
    s3 = _sd_sphere(p, (-4.0, 24.0, 9.0), 7.0)
    far_s = jnp.minimum(jnp.minimum(s1, s2), s3)

    sdfs = jnp.stack([ground, pillars, far_s], axis=-1)
    sdf = jnp.min(sdfs, axis=-1)
    prim = jnp.argmin(sdfs, axis=-1)
    sigma_b = 60.0 * jax.nn.sigmoid(-sdf * sharpness)

    palette = jnp.asarray([
        [0.45, 0.42, 0.38],  # ground: warm gray
        [0.70, 0.30, 0.20],  # pillars: brick
        [0.25, 0.45, 0.75],  # far spheres: blue
    ], jnp.float32)
    base = palette[prim]
    # textures scale with distance (constant angular frequency as seen
    # from the origin): rings on the ground, azimuth stripes elsewhere
    rings = 0.5 + 0.5 * jnp.sin(3.0 * rad)
    stripes = 0.5 + 0.5 * jnp.sin(12.0 * az + 1.5 * p[..., 2])
    mod = jnp.where(prim == 0, 0.4 + 0.6 * rings, 0.45 + 0.55 * stripes)
    rgb_b = jnp.clip(base * mod[..., None], 0.0, 1.0)

    # union of the central field and the background field: densities
    # add; color is the density-weighted mix (exact for disjoint
    # supports, which these are by construction)
    sigma = sigma_c + sigma_b
    w = sigma_c / jnp.maximum(sigma, 1e-6)
    rgb = w[..., None] * rgb_c + (1.0 - w[..., None]) * rgb_b
    return sigma, rgb


def field_deep(points: jnp.ndarray, sharpness: float = 50.0
               ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """TRULY deep unbounded scene ("deep360", VERDICT r4 task 3):
    content spanning t in [~3, 2500] — three decades of depth, built to
    measure where scene contraction is load-bearing rather than merely
    plausible. lego360's far plane (t=60) let raw-coordinate PE fit the
    whole scene; here the raw positions reach |x| ~ 2500, where the
    un-contracted encoding fails twice over: the PE's base frequency
    (period 2 pi) aliases ~400x across the range, and the raw-input
    lanes (include_input_in_enc) feed |x| ~ 2.5e3 magnitudes into a
    unit-scale MLP. Contraction maps all of it into radius < 2.

    Layers (all angularly textured — the far field is an environment,
    matching what real 360 captures have at depth):
      * the lego-class central object + ground disc + pillar ring of
        field_360 (t ~ 3-45 from the camera ring)
      * three landmark spheres at radius 100-160 (r = 24-34)
      * a torus ring at radius 350 (tube r = 60)
      * an enclosing sky SHELL at radius 1300-2500: every ray
        terminates on angular texture, so the scene needs no
        background convention at any far plane
    Primitive sizes grow ~linearly with distance (constant angular
    size), the regime disparity sampling and the gold integrator's
    1/t spacing both resolve."""
    p = points
    sigma_near, rgb_near = field_360(p, sharpness=sharpness)

    R = jnp.sqrt(jnp.sum(p * p, axis=-1))
    az = jnp.arctan2(p[..., 1], p[..., 0])
    el = jnp.arctan2(p[..., 2], jnp.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2))

    s1 = _sd_sphere(p, (110.0, 40.0, 30.0), 24.0)
    s2 = _sd_sphere(p, (-80.0, -120.0, 50.0), 30.0)
    s3 = _sd_sphere(p, (-30.0, 150.0, 70.0), 34.0)
    landmarks = jnp.minimum(jnp.minimum(s1, s2), s3)
    ring = _sd_torus(p, (0.0, 0.0, 40.0), 350.0, 60.0)
    # solid shell: occupied between radii 1300 and 2500
    sky = jnp.maximum(1300.0 - R, R - 2500.0)

    sdfs = jnp.stack([landmarks, ring, sky], axis=-1)
    sdf = jnp.min(sdfs, axis=-1)
    prim = jnp.argmin(sdfs, axis=-1)
    # far surfaces use a soft, SCALE-MATCHED sharpness (their gold
    # sample spacing is tens-to-hundreds of units)
    far_sharp = jnp.where(prim == 2, 0.02, 0.15)
    sigma_far = 60.0 * jax.nn.sigmoid(-sdf * far_sharp)

    palette = jnp.asarray([
        [0.85, 0.55, 0.20],  # landmark spheres: amber
        [0.30, 0.65, 0.35],  # ring: green
        [0.40, 0.45, 0.80],  # sky shell: blue
    ], jnp.float32)
    base = palette[prim]
    # angular texture (constant frequency as seen from the origin):
    # what an environment at any depth actually looks like
    stripes = 0.5 + 0.5 * jnp.sin(6.0 * az) * jnp.sin(8.0 * el + 1.0)
    rgb_far = jnp.clip(base * (0.45 + 0.55 * stripes)[..., None], 0.0, 1.0)

    sigma = sigma_near + sigma_far
    w = sigma_near / jnp.maximum(sigma, 1e-6)
    rgb = w[..., None] * rgb_near + (1.0 - w[..., None]) * rgb_far
    return sigma, rgb


def forward_facing_poses(n: int, seed: int) -> np.ndarray:
    """n cameras jittered on a small plane near the world origin, all
    looking toward the content plane at z = -FACING_DEPTH — an
    LLFF-style forward-facing rig (cameras toward -z, the convention
    ``ops/rays.ndc_rays`` warps)."""
    rng = np.random.default_rng(seed)
    eyes = np.stack([
        rng.uniform(-0.45, 0.45, n),
        rng.uniform(-0.45, 0.45, n),
        rng.uniform(-0.15, 0.15, n),
    ], axis=-1)
    targets = np.stack([
        rng.uniform(-0.2, 0.2, n),
        rng.uniform(-0.2, 0.2, n),
        np.full(n, -FACING_DEPTH),
    ], axis=-1)
    return np.stack([
        look_at_c2w(e, target=t, up=(0.0, 1.0, 0.0))
        for e, t in zip(eyes, targets)
    ]).astype(np.float32)


FIELDS = {"lego": field, "helix": field_helix, "facing": field_facing,
          "lego360": field_360, "deep360": field_deep}


def look_at_c2w(eye: np.ndarray, target=(0.0, 0.0, 0.15),
                up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """Blender-convention c2w (camera -z forward, +y up in view)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    u = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, u, -fwd, eye
    return c2w


def hemisphere_poses(n: int, seed: int, radius: float = CAMERA_RADIUS
                     ) -> np.ndarray:
    """n cameras on the upper hemisphere (z > 0.2 rad elevation band),
    deterministic in seed — train/val/test use different seeds so the
    test split is genuinely held out."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0.0, 2.0 * math.pi, n)
    elev = rng.uniform(0.15, 1.25, n)  # radians above the horizon
    poses = []
    for t, e in zip(theta, elev):
        eye = radius * np.asarray([
            math.cos(t) * math.cos(e), math.sin(t) * math.cos(e), math.sin(e)
        ])
        poses.append(look_at_c2w(eye))
    return np.stack(poses).astype(np.float32)


def render_gold(c2w, height: int, width: int, focal: float,
                near: float = 2.0, far: float = 6.0,
                num_samples: int = 512, chunk: int = 4096,
                field_fn=field, space: str = "linear") -> np.ndarray:
    # chunk=4096 bounds the (chunk, S, 3|5) point/sdf temps
    """Integrate the analytic field to an (H, W, 4) float frame
    (unpremultiplied rgb + alpha=acc), chunked over rays.

    ``space="disparity"`` integrates on 1/t-even midpoints (the
    unbounded lego360 scene: far content needs metric spacing that
    grows with distance, and the trained model samples the same way)."""
    from ..ops import rays as rays_ops
    from ..ops.render import composite
    from ..ops.sampling import deltas_from_ts

    o, d = rays_ops.ray_grid_c2w(jnp.asarray(c2w), height, width, focal)
    flat_o = o.reshape(-1, 3)
    flat_d = d.reshape(-1, 3)
    n = flat_o.shape[0]
    pad = (-n) % chunk
    if pad:
        flat_o = jnp.concatenate([flat_o, jnp.zeros((pad, 3))])
        flat_d = jnp.concatenate([flat_d, jnp.ones((pad, 3))])
    if space == "disparity":
        ts = 1.0 / jnp.linspace(1.0 / near, 1.0 / far, num_samples + 1)
    else:
        ts = jnp.linspace(near, far, num_samples + 1)
    ts = 0.5 * (ts[:-1] + ts[1:])  # bin midpoints

    @jax.jit
    def render_chunk(od):
        oc, dc = od
        pts = oc[:, None, :] + ts[None, :, None] * dc[:, None, :]
        sigma, rgb = field_fn(pts)
        tsb = jnp.broadcast_to(ts, sigma.shape)
        out = composite(sigma, rgb, deltas_from_ts(tsb, far), ts=tsb)
        return out.rgb, out.acc

    rgbs, accs = jax.lax.map(
        render_chunk,
        (flat_o.reshape(-1, chunk, 3), flat_d.reshape(-1, chunk, 3)),
    )
    rgb = np.asarray(rgbs.reshape(-1, 3)[:n]).reshape(height, width, 3)
    acc = np.asarray(accs.reshape(-1)[:n]).reshape(height, width, 1)
    un = rgb / np.maximum(acc, 1e-6)  # PNG stores unpremultiplied rgb
    return np.clip(np.concatenate([un, acc], axis=-1), 0.0, 1.0)


def make_blender_scene(out_dir: str, size: int = 800, n_train: int = 100,
                       n_val: int = 10, n_test: int = 25,
                       num_samples: int = 512, seed: int = 0,
                       verbose: bool = True, scene: str = "lego") -> None:
    """Write a complete Blender-format scene directory for the named
    procedural field (``FIELDS``: "lego" or "helix")."""
    field_fn = FIELDS[scene]
    from .images import save_png

    # forward-facing scene: LLFF-style rig + content-bracketing planes;
    # lego360: unbounded surroundings -> disparity-spaced gold
    # integration over [0.3, 60] (see field_360 / --preset unbounded)
    facing = scene == "facing"
    pose_fn = forward_facing_poses if facing else hemisphere_poses
    near, far = (1.5, 7.5) if facing else (2.0, 6.0)
    space = "linear"
    if scene == "lego360":
        near, far, space = 0.3, 60.0, "disparity"
        num_samples = max(num_samples, 1024)
    elif scene == "deep360":
        # three-decade depth range: 1/t-spaced gold integration at
        # 3072 samples puts ~7-unit spacing at the landmark spheres
        # (t ~ 120) and guarantees multiple samples inside the
        # 1200-unit sky shell (spacing ~1100 at t ~ 1500)
        near, far, space = 1.0, 2500.0, "disparity"
        num_samples = max(num_samples, 3072)
    focal = 0.5 * size / math.tan(0.5 * CAMERA_ANGLE_X)
    splits = [("train", n_train, seed + 1), ("val", n_val, seed + 2),
              ("test", n_test, seed + 3)]
    # scale the ray chunk down with the sample count: the (chunk, S, 3)
    # point temps make chunk * S the memory knob (4096 x 512 ray-samples
    # per chunk)
    chunk = max(512, 4096 * 512 // num_samples)
    for split, n, s in splits:
        os.makedirs(os.path.join(out_dir, split), exist_ok=True)
        poses = pose_fn(n, s)
        frames = []
        for i in range(n):
            img = render_gold(poses[i], size, size, focal, near=near,
                              far=far, num_samples=num_samples,
                              field_fn=field_fn, space=space, chunk=chunk)
            save_png(os.path.join(out_dir, split, f"r_{i}.png"), img)
            frames.append({
                "file_path": f"./{split}/r_{i}",
                "transform_matrix": poses[i].tolist(),
            })
            if verbose and (i + 1) % 10 == 0:
                print(f"{split}: {i + 1}/{n} frames", flush=True)
        with open(os.path.join(out_dir, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames}, f)
    if verbose:
        print(f"scene written to {out_dir}")
