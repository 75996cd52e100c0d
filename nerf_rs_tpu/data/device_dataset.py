"""Device-resident dataset: zero-host-work per-step batch sampling.

The device-side inversion of the reference's hot CPU batch loop
(get_multiview_batch, src/dataset.rs:63-139, which assembles 84 rays x
64 points of scalar vecmath per frame): all view images live in device
memory as
one uint8 array (a 128x128x84-view scene is ~5.5 MB; 800x800x100 lego
is ~256 MB), and one jitted function does view sampling, pixel-coord
sampling, gold gather, and ray generation entirely on-device. The host
contributes nothing per step but the PRNG key fold.

Batch semantics ported from the reference:
  * views sampled WITH replacement (randint, src/dataset.rs:88-93)
  * rays split evenly across sampled views with the same divisibility
    requirement (src/dataset.rs:73-81)
plus a generalized ``per_ray`` mode (every ray draws its own view —
better mixing, the full-epoch-shuffle analogue of SURVEY §7 step 7).

The pixel store is passed to the jitted samplers as a runtime argument
(NOT closed over), so it is never baked into the HLO as a constant —
important for the 800x800 scenes.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CameraConfig
from ..ops import rays as rays_ops
from ..train.step import Batch


def _gather_gold(images, view_idx, xi, yi, white_background: bool):
    px = images[view_idx, yi, xi].astype(jnp.float32) / 255.0
    rgb, alpha = px[..., :3], px[..., 3:4]
    if white_background:
        rgb = rgb * alpha + (1.0 - alpha)
    return rgb


def _make_rays(pose_data, mode, coords_xy, view_idx, camera, height, width):
    if mode == "angles":
        a = pose_data[view_idx]
        pose = rays_ops.pose_from_yaw_pitch(a[..., 0], a[..., 1])
        o, d = rays_ops.rays_for_coords(coords_xy, pose, camera)
    else:
        assert camera.focal is not None, "c2w mode requires camera.focal"
        o, d = rays_ops.rays_from_c2w(
            coords_xy, pose_data[view_idx], height, width, camera.focal
        )
    return rays_ops.maybe_ndc(o, d, camera)


@partial(
    jax.jit,
    static_argnames=("num_rays", "mode", "white_background", "camera", "height", "width", "num_views"),
)
def _sample_per_ray(
    images, pose_data, key, num_rays, mode, white_background, camera, height, width, num_views
) -> Batch:
    kv, kx, ky = jax.random.split(key, 3)
    view_idx = jax.random.randint(kv, (num_rays,), 0, num_views)
    xi = jax.random.randint(kx, (num_rays,), 0, width)
    yi = jax.random.randint(ky, (num_rays,), 0, height)
    coords = jnp.stack([xi, yi], axis=-1).astype(jnp.float32)
    o, d = _make_rays(pose_data, mode, coords, view_idx, camera, height, width)
    gold = _gather_gold(images, view_idx, xi, yi, white_background)
    idx = (view_idx * height + yi) * width + xi  # flat pixel id (diagnostics)
    return Batch(origins=o, dirs=d, gold=gold, idx=idx)


@partial(
    jax.jit,
    static_argnames=("num_rays", "mode", "white_background", "camera",
                     "height", "width", "num_views"),
)
def _sample_per_ray_ms(
    ms_images, pose_data, key, num_rays, mode, white_background, camera,
    height, width, num_views,
) -> Batch:
    """Multiscale ``per_ray`` sampling (mip-NeRF, arXiv 2103.13415 §4):
    the batch is partitioned into len(ms_images) equal level blocks;
    level l draws (view, x, y) iid on the 1/2^l pyramid store and its
    rays carry the 2^l-wide cone radius (Batch.radii). Equal per-level
    counts == the paper's area-weighted union sampling in expectation
    (see DataConfig.multiscale_levels)."""
    from ..ops.sampling import pixel_radius

    L = len(ms_images)
    counts = [num_rays // L] * L
    counts[0] += num_rays - sum(counts)
    parts = []
    for lvl, (imgs_l, n_l) in enumerate(zip(ms_images, counts)):
        kv, kx, ky = jax.random.split(jax.random.fold_in(key, lvl), 3)
        h_l, w_l = height >> lvl, width >> lvl
        cam_l = dataclasses.replace(
            camera, width=w_l, height=h_l,
            focal=None if camera.focal is None else camera.focal / (1 << lvl),
        )
        view_idx = jax.random.randint(kv, (n_l,), 0, num_views)
        xi = jax.random.randint(kx, (n_l,), 0, w_l)
        yi = jax.random.randint(ky, (n_l,), 0, h_l)
        coords = jnp.stack([xi, yi], axis=-1).astype(jnp.float32)
        o, d = _make_rays(pose_data, mode, coords, view_idx, cam_l, h_l, w_l)
        gold = _gather_gold(imgs_l, view_idx, xi, yi, white_background)
        radii = jnp.full((n_l,), pixel_radius(cam_l), jnp.float32)
        # diagnostics id in the LEVEL-0 namespace: the block's corner pixel
        idx = (view_idx * height + (yi << lvl)) * width + (xi << lvl)
        parts.append(Batch(o, d, gold, idx=idx, radii=radii))
    return jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs, axis=0), *parts
    )


def build_pyramid(images: np.ndarray, levels: int,
                  white_background: bool) -> Tuple[np.ndarray, ...]:
    """Host-side box pyramid of a (V, H, W, 4) uint8 RGBA store.

    Level l > 0 stores the 2^l-box average of the level-0 GOLD value
    (alpha composited per the dataset's background convention FIRST,
    then area-averaged — the order ``view_gold(v, scale)`` uses) with
    alpha=255, so ``_gather_gold`` returns the stored value unchanged in
    either background mode. Matches view_gold up to uint8 rounding."""
    out = [images]
    v, h, w, _ = images.shape
    f = images.astype(np.float32)
    rgb, a = f[..., :3], f[..., 3:4] / 255.0
    gold = rgb * a + 255.0 * (1.0 - a) if white_background else rgb
    for lvl in range(1, levels):
        s = 1 << lvl
        assert h % s == 0 and w % s == 0, (h, w, s)
        mean = gold.reshape(v, h // s, s, w // s, s, 3).mean(axis=(2, 4))
        lvl_img = np.concatenate(
            [np.clip(mean, 0, 255),
             np.full(mean.shape[:-1] + (1,), 255.0, np.float32)], axis=-1
        )
        out.append(np.round(lvl_img).astype(np.uint8))
    return tuple(out)


@partial(
    jax.jit,
    static_argnames=(
        "num_rays", "views_per_batch", "mode", "white_background", "camera", "height", "width", "num_views",
    ),
)
def _sample_multiview(
    images, pose_data, key, num_rays, views_per_batch, mode, white_background,
    camera, height, width, num_views,
) -> Batch:
    per_view = num_rays // views_per_batch
    kv, kx, ky = jax.random.split(key, 3)
    views = jax.random.randint(kv, (views_per_batch,), 0, num_views)
    view_idx = jnp.repeat(views, per_view)
    xi = jax.random.randint(kx, (num_rays,), 0, width)
    yi = jax.random.randint(ky, (num_rays,), 0, height)
    coords = jnp.stack([xi, yi], axis=-1).astype(jnp.float32)
    o, d = _make_rays(pose_data, mode, coords, view_idx, camera, height, width)
    gold = _gather_gold(images, view_idx, xi, yi, white_background)
    idx = (view_idx * height + yi) * width + xi
    return Batch(origins=o, dirs=d, gold=gold, idx=idx)


@partial(
    jax.jit,
    static_argnames=(
        "num_rays", "num_err", "mode", "white_background", "camera", "height", "width", "num_views",
    ),
)
def _sample_error_weighted(
    images, pose_data, err_store, key, num_rays, num_err, mode,
    white_background, camera, height, width, num_views,
) -> Batch:
    """Mixture sampling: num_err rays from the per-pixel error
    distribution (inverse-CDF over the error store — O(P) cumsum, not
    the O(n*P) broadcast of jax.random.categorical), the rest uniform.
    Implements the reference's README TODO 'resample rays with highest
    error' (BASELINE config 5)."""
    kc, ku, kv = jax.random.split(key, 3)
    cdf = jnp.cumsum(err_store + 1e-8)
    u = jax.random.uniform(kc, (num_err,)) * cdf[-1]
    idx_err = jnp.clip(jnp.searchsorted(cdf, u), 0, err_store.shape[0] - 1)
    idx_uni = jax.random.randint(
        ku, (num_rays - num_err,), 0, num_views * height * width
    )
    idx = jnp.concatenate([idx_err, idx_uni])
    view_idx = idx // (height * width)
    rem = idx % (height * width)
    yi = rem // width
    xi = rem % width
    coords = jnp.stack([xi, yi], axis=-1).astype(jnp.float32)
    o, d = _make_rays(pose_data, mode, coords, view_idx, camera, height, width)
    gold = _gather_gold(images, view_idx, xi, yi, white_background)
    return Batch(origins=o, dirs=d, gold=gold, idx=idx)


@jax.jit
def update_error_store(
    err_store: jnp.ndarray, idx: jnp.ndarray, ray_err: jnp.ndarray,
    ema: float = 0.5,
) -> jnp.ndarray:
    """EMA-scatter per-ray errors back into the pixel error store."""
    old = err_store[idx]
    return err_store.at[idx].set((1.0 - ema) * old + ema * ray_err)


class DeviceDataset:
    """Multiview images + poses resident on device.

    Args:
      images: (N, H, W, 3|4) uint8 or float host array.
      camera: intrinsics (for c2w mode, ``focal`` must be set).
      angles: (N, 2) yaw/pitch per view (reference hemisphere layout), or
      c2w: (N, 4, 4) Blender camera-to-world matrices. Exactly one.
      white_background: composite gold RGBA onto white (Blender lego);
        otherwise alpha is dropped and training targets RGB.
      sharding: optional jax.sharding.Sharding to place the pixel store
        (replicate for DP; the batch itself is sharded downstream).
    """

    def __init__(
        self,
        images,
        camera: CameraConfig,
        angles=None,
        c2w=None,
        white_background: bool = False,
        sharding=None,
        multiscale_levels: int = 1,
    ):
        assert (angles is None) != (c2w is None), "provide exactly one of angles/c2w"
        images = np.asarray(images)
        if images.dtype != np.uint8:
            images = np.clip(np.asarray(images, np.float32) * 255.0, 0, 255).astype(
                np.uint8
            )
        if images.shape[-1] == 3:
            alpha = np.full(images.shape[:-1] + (1,), 255, np.uint8)
            images = np.concatenate([images, alpha], axis=-1)
        self.num_views, self.height, self.width = images.shape[:3]
        self.camera = camera
        self.white_background = white_background
        self.mode = "angles" if angles is not None else "c2w"
        if sharding is None:
            put = jnp.asarray
        elif not (sharding.is_fully_replicated
                  or sharding.is_fully_addressable):
            # view-sharded store across hosts: each process contributes
            # its local view slice to ONE global array whose view axis
            # is laid out over the whole mesh (the device form of the
            # process_shard slicing in data/factory.py). Detected via
            # addressability, NOT jax.process_count() — the latter
            # touches the default backend, which the hermetic dryrun
            # deliberately poisons (test_graft_entry.py).
            put = lambda x: jax.make_array_from_process_local_data(
                sharding, x
            )
        else:
            put = lambda x: jax.device_put(x, sharding)
        # host copies feed the async PrefetchPipeline (batch_mode="host")
        # without a device round-trip
        self.host_images = images
        pose_host = np.asarray(angles if angles is not None else c2w, np.float32)
        self.host_poses = pose_host
        self.images = put(images)
        self.pose_data = put(pose_host)
        self.multiscale_levels = multiscale_levels
        if multiscale_levels > 1:
            pyr = build_pyramid(images, multiscale_levels, white_background)
            self.ms_images = (self.images,) + tuple(put(p) for p in pyr[1:])
        else:
            self.ms_images = None

    @property
    def train_store(self):
        """What the in-step sampler consumes: the pixel store, or the
        multiscale pyramid tuple (one jit/pytree arg either way)."""
        return self.ms_images if self.ms_images is not None else self.images

    def sample_batch(self, key: jax.Array, num_rays: int) -> Batch:
        """``per_ray`` sampling: every ray draws (view, x, y) iid."""
        if self.ms_images is not None:
            return _sample_per_ray_ms(
                self.ms_images, self.pose_data, key, num_rays, self.mode,
                self.white_background, self.camera, self.height, self.width,
                self.num_views,
            )
        return _sample_per_ray(
            self.images, self.pose_data, key, num_rays, self.mode,
            self.white_background, self.camera, self.height, self.width,
            self.num_views,
        )

    def sample_multiview_batch(
        self, key: jax.Array, num_rays: int, views_per_batch: int
    ) -> Batch:
        """Reference semantics (src/dataset.rs:63-139): sample
        ``views_per_batch`` views with replacement; split rays evenly
        (num_rays must divide evenly, as the reference asserts at
        src/dataset.rs:73-81)."""
        assert num_rays % views_per_batch == 0, (
            "num_rays must be divisible by views_per_batch"
        )
        return _sample_multiview(
            self.images, self.pose_data, key, num_rays, views_per_batch,
            self.mode, self.white_background, self.camera, self.height,
            self.width, self.num_views,
        )

    def batch_from_idx(self, idx: jnp.ndarray) -> Batch:
        """Reconstruct the exact batch a flat pixel-index vector denotes
        (used by diagnostics when sampling happens inside the jitted
        step and only aux['batch_idx'] leaves the device)."""
        view_idx = idx // (self.height * self.width)
        rem = idx % (self.height * self.width)
        yi = rem // self.width
        xi = rem % self.width
        coords = jnp.stack([xi, yi], axis=-1).astype(jnp.float32)
        o, d = _make_rays(self.pose_data, self.mode, coords, view_idx,
                          self.camera, self.height, self.width)
        gold = _gather_gold(self.images, view_idx, xi, yi,
                            self.white_background)
        return Batch(origins=o, dirs=d, gold=gold, idx=idx)

    # -- highest-error resampling (BASELINE config 5) -------------------------

    def init_error_store(self, initial: float = 1.0) -> jnp.ndarray:
        """Flat (views*H*W,) per-pixel error buffer; optimistic init so
        unseen pixels stay likely to be drawn."""
        return jnp.full(
            (self.num_views * self.height * self.width,), initial, jnp.float32
        )

    def sample_batch_error_weighted(
        self, key: jax.Array, num_rays: int, err_store: jnp.ndarray,
        error_frac: float = 0.5,
    ) -> Batch:
        """error_frac of the batch from the error distribution, rest
        uniform; Batch.idx carries pixel ids for update_error_store."""
        num_err = int(num_rays * error_frac)
        return _sample_error_weighted(
            self.images, self.pose_data, err_store, key, num_rays, num_err,
            self.mode, self.white_background, self.camera, self.height,
            self.width, self.num_views,
        )

    # -- eval / render helpers ----------------------------------------------

    def scaled_camera(self, scale: int) -> CameraConfig:
        """The camera that shoots one ray per ``scale`` x ``scale`` pixel
        block: same FOV, 1/scale resolution (and focal, when explicit).
        The IPE pixel footprint (ops/sampling.pixel_radius) widens by
        ``scale`` through it — multiscale anti-aliased rendering
        (mip-NeRF, arXiv 2103.13415 §4) needs no other plumbing."""
        cam = self.camera
        assert self.height % scale == 0 and self.width % scale == 0, (
            self.height, self.width, scale)
        return dataclasses.replace(
            cam, width=cam.width // scale, height=cam.height // scale,
            focal=None if cam.focal is None else cam.focal / scale,
        )

    def view_rays(
        self, view: int, scale: int = 1
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Full-frame (H/scale, W/scale) rays for one training view,
        through the centers of ``scale``-wide pixel blocks."""
        camera = self.camera if scale == 1 else self.scaled_camera(scale)
        if self.mode == "angles":
            a = self.pose_data[view]
            pose = rays_ops.pose_from_yaw_pitch(a[0], a[1])
            o, d = rays_ops.ray_grid(pose, camera)
        else:
            o, d = rays_ops.ray_grid_c2w(
                self.pose_data[view], self.height // scale,
                self.width // scale, self.camera.focal / scale,
            )
        return rays_ops.maybe_ndc(o, d, camera)

    def view_gold(self, view: int, scale: int = 1) -> jnp.ndarray:
        """Gold (H/scale, W/scale, 3) frame for PSNR eval. ``scale`` > 1
        box-downsamples (the area average IS the anti-aliased reference
        a correctly prefiltered render should match; alpha compositing
        happens before averaging, matching a downsample of the
        composited frame)."""
        px = self.images[view].astype(jnp.float32) / 255.0
        rgb, alpha = px[..., :3], px[..., 3:4]
        if self.white_background:
            rgb = rgb * alpha + (1.0 - alpha)
        if scale > 1:
            h, w = self.height // scale, self.width // scale
            rgb = rgb.reshape(h, scale, w, scale, 3).mean(axis=(1, 3))
        return rgb
