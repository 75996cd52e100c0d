"""Dataset factory: Config -> DeviceDataset.

Covers the reference's dataset surface (--img_dir multiview PNGs with
the hemisphere angle grid, src/cli.rs:19-32 + src/image_loading.rs) and
the additions: Blender transforms.json scenes and the file-free
synthetic sphere fixtures (SURVEY §2.6).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..config import Config
from ..ops import rays as rays_ops
from . import blender, images, synthetic
from .device_dataset import DeviceDataset


def make_dataset(
    cfg: Config,
    split: str = "train",
    sharding=None,
    process_shard=None,
    local_multiple: int = 1,
) -> DeviceDataset:
    """Build the on-device dataset for ``cfg``.

    ``process_shard=(index, count)`` keeps only views
    ``[index::count]`` — multi-host pixel-store sharding (SURVEY §5.8
    rebuild plan): each host process loads and stores a disjoint view
    subset, so large pixel stores split across host and device memory instead
    of replicating. Per-ray batches draw (view, x, y) iid, so each
    process sampling its local slice is statistically the same as every
    process sampling the union.

    ``local_multiple``: additionally round the (per-process) view count
    up to a multiple of this — the device-sharded pixel store
    (DataConfig.shard_pixel_store) needs the view axis to divide evenly
    over each process's devices.
    """

    def _slice(*arrays):
        n = arrays[0].shape[0]
        if process_shard is None:
            locals_, idx, count, per = arrays, 0, 1, n
        else:
            idx, count = process_shard
            assert 0 <= idx < count, (idx, count)
            # Every process must end with the SAME per-process length:
            # with n % count != 0, a[idx::count] gives hosts
            # different-shaped stores, and a global-mesh jit program
            # then compiles mismatched executables across processes
            # (hang/crash). Shapes are equalized by padding UP to
            # ceil(n / count) — never by dropping views.
            locals_ = tuple(a[idx::count] for a in arrays)
            per = -(-n // count)
        m = max(local_multiple, 1)
        per = -(-per // m) * m  # round up to the device multiple
        k = locals_[0].shape[0]
        assert k > 0, f"process {idx}/{count} got no views"
        if per == k:
            return locals_
        # Pad by cyclic repetition of this process's own views: NO view
        # is ever dropped (round-3 verdict weak #7 — the old equal-
        # length truncation silently lost up to count-1 views). Per-ray
        # batches sample (view, x, y) iid over the padded store, so a
        # wrapped view carries ceil(per/k)/floor(per/k) ~ at most 2x
        # the sampling weight of its peers — a bounded, documented bias
        # vs. the unbounded one of views never being trained on at all.
        reps = np.arange(per) % k
        return tuple(a[reps] for a in locals_)

    d = cfg.data
    if d.dataset in ("sphere", "flat_sphere"):
        n_views = 2 * d.num_views_per_hemisphere * (d.num_views_per_hemisphere + 1)
        imgs = np.asarray(synthetic.sphere_scene_images(cfg.camera, n_views))
        angles = np.asarray(rays_ops.view_angle_grid(d.num_views_per_hemisphere))
        imgs, angles = _slice(imgs, angles)
        return DeviceDataset(
            imgs, cfg.camera, angles=angles,
            white_background=cfg.render.white_background, sharding=sharding,
            multiscale_levels=d.multiscale_levels,
        )
    if d.dataset == "multiview_png":
        imgs, h, w = images.load_multiview_dir(
            d.img_dir, d.view_start, d.view_end, d.view_step
        )
        assert (h, w) == (cfg.camera.height, cfg.camera.width), (
            f"images are {h}x{w} but camera is "
            f"{cfg.camera.height}x{cfg.camera.width}"
        )
        angles = np.asarray(
            rays_ops.view_angle_grid(d.num_views_per_hemisphere)
        )[d.view_start : d.view_end : d.view_step]
        assert angles.shape[0] == imgs.shape[0]
        imgs, angles = _slice(imgs, angles)
        return DeviceDataset(
            imgs, cfg.camera, angles=angles,
            white_background=cfg.render.white_background, sharding=sharding,
            multiscale_levels=d.multiscale_levels,
        )
    if d.dataset == "llff":
        from . import llff

        scene = llff.load_llff(
            d.img_dir, split=split, factor=d.llff_factor,
            holdout=d.llff_holdout,
        )
        cam = cfg.camera
        # NDC mode (the standard for these captures) keeps the
        # configured [0, 1] range; metric mode inherits the capture's
        # own COLMAP bounds unless the user set near/far — explicitly
        # on the CLI (DataConfig.near_explicit/far_explicit, ADVICE r4)
        # or, for library callers, by moving the value off the
        # dataclass default
        defaults = {f.name: f.default for f in dataclasses.fields(cam)}
        if cam.ndc:
            near, far = cam.near, cam.far
        else:
            near = (cam.near if d.near_explicit
                    or cam.near != defaults["near"] else scene.near)
            far = (cam.far if d.far_explicit
                   or cam.far != defaults["far"] else scene.far)
        camera = cam.__class__(
            width=scene.width,
            height=scene.height,
            fov=2.0 * math.atan(0.5 * scene.width / scene.focal),
            near=near,
            far=far,
            focal=float(scene.focal),
            ndc=cam.ndc,
            ndc_near=cam.ndc_near,
        )
        imgs, c2w = _slice(scene.images, scene.c2w)
        return DeviceDataset(
            imgs, camera, c2w=c2w,
            white_background=cfg.render.white_background, sharding=sharding,
            multiscale_levels=d.multiscale_levels,
        )
    if d.dataset == "blender":
        scene = blender.load_blender(d.img_dir, split=split)
        cam = cfg.camera
        camera = cam.__class__(
            width=scene.width,
            height=scene.height,
            fov=2.0 * math.atan(0.5 * scene.width / scene.focal),
            near=cam.near,
            far=cam.far,
            focal=float(scene.focal),
            ndc=cam.ndc,
            ndc_near=cam.ndc_near,
        )
        imgs, c2w = _slice(scene.images, scene.c2w)
        return DeviceDataset(
            imgs, camera, c2w=c2w,
            white_background=cfg.render.white_background, sharding=sharding,
            multiscale_levels=d.multiscale_levels,
        )
    raise ValueError(f"unknown dataset: {d.dataset}")
