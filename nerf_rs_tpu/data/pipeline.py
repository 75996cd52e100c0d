"""Async host pixel-batch pipeline with prefetch.

For scenes whose pixel store exceeds device memory (or when host-side gather is
preferred), a background thread assembles (view, x, y, gold) index
batches from the host pixel array and stages them ahead of the
consumer; ray generation still happens on-device from the indices.
This is the "async host pipeline: background thread producing
(ray_o, ray_d, gold) shards, double-buffered device_put" of SURVEY §7
step 7 — the reference assembles its batch synchronously inside the
frame callback (src/main.rs:57).

The gold-gather inner loop can be delegated to the C++ native batch
assembler (native/, see data/native_loader.py) when built; the numpy
path is the always-available fallback.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CameraConfig
from ..ops import rays as rays_ops
from ..train.step import Batch


class HostSampler:
    """Samples (view_idx, xi, yi, gold) batches from a host pixel array."""

    def __init__(self, images: np.ndarray, white_background: bool, seed, gather_fn=None):
        assert images.dtype == np.uint8 and images.ndim == 4
        self.images = images
        self.white_background = white_background
        self.rng = np.random.default_rng(seed)
        self.num_views, self.height, self.width = images.shape[:3]
        self._gather = gather_fn  # optional native (C++) gather

    def sample(self, num_rays: int):
        view_idx = self.rng.integers(0, self.num_views, num_rays, dtype=np.int32)
        xi = self.rng.integers(0, self.width, num_rays, dtype=np.int32)
        yi = self.rng.integers(0, self.height, num_rays, dtype=np.int32)
        if self._gather is not None:
            gold = self._gather(self.images, view_idx, xi, yi, self.white_background)
        else:
            px = self.images[view_idx, yi, xi].astype(np.float32) / 255.0
            rgb, alpha = px[:, :3], px[:, 3:4]
            gold = rgb * alpha + (1.0 - alpha) if self.white_background else rgb
        return view_idx, xi, yi, gold


class PrefetchPipeline:
    """Background-threaded batch producer.

    Yields device-ready Batches; host sampling for batch k+1..k+depth
    overlaps device compute of batch k. Ray generation from the sampled
    indices runs on-device (jitted in the first call).

    ``num_workers > 1`` assembles batches in parallel producer threads
    (each with its own counter-derived PRNG stream, so every worker's
    batch *sequence* is deterministic; only the interleave order across
    workers is scheduler-dependent — fine for iid per-ray sampling).
    Both gather paths drop the GIL for the bulk of the work (the C++
    assembler via ctypes, numpy fancy indexing internally), so workers
    scale on real cores.
    """

    def __init__(
        self,
        images: np.ndarray,
        camera: CameraConfig,
        angles: Optional[np.ndarray] = None,
        c2w: Optional[np.ndarray] = None,
        num_rays: int = 4096,
        white_background: bool = False,
        depth: int = 2,
        seed: int = 0,
        gather_fn=None,
        use_native: bool = False,
        num_workers: int = 1,
    ):
        assert (angles is None) != (c2w is None)
        if use_native and gather_fn is None:
            from . import native_loader

            if native_loader.load() is not None:
                gather_fn = native_loader.gather_gold
        if images.dtype != np.uint8:
            images = np.clip(images * 255.0, 0, 255).astype(np.uint8)
        if images.shape[-1] == 3:
            images = np.concatenate(
                [images, np.full(images.shape[:-1] + (1,), 255, np.uint8)], axis=-1
            )
        assert num_workers >= 1, num_workers
        self.camera = camera
        self.num_rays = num_rays
        self.mode = "angles" if angles is not None else "c2w"
        self.pose_data = jnp.asarray(
            np.asarray(angles if angles is not None else c2w, np.float32)
        )
        self.height, self.width = images.shape[1:3]
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, num_workers))
        self._stop = threading.Event()
        # one sampler per worker: independent PRNG stream, shared
        # read-only pixel array (no copy)
        self._samplers = [
            HostSampler(images, white_background, [seed, w], gather_fn)
            for w in range(num_workers)
        ]
        self.sampler = self._samplers[0]  # back-compat alias
        self._threads = [
            threading.Thread(target=self._produce, args=(s,), daemon=True)
            for s in self._samplers
        ]
        for t in self._threads:
            t.start()
        self._ray_fn = jax.jit(self._make_rays)

    def _make_rays(self, view_idx, coords):
        if self.mode == "angles":
            a = self.pose_data[view_idx]
            pose = rays_ops.pose_from_yaw_pitch(a[..., 0], a[..., 1])
            o, d = rays_ops.rays_for_coords(coords, pose, self.camera)
        else:
            o, d = rays_ops.rays_from_c2w(
                coords, self.pose_data[view_idx], self.height, self.width,
                self.camera.focal,
            )
        return rays_ops.maybe_ndc(o, d, self.camera)

    def _produce(self, sampler: HostSampler):
        while not self._stop.is_set():
            item = sampler.sample(self.num_rays)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[Batch]:
        return self

    def __next__(self) -> Batch:
        view_idx, xi, yi, gold = self._q.get()
        coords = jnp.asarray(np.stack([xi, yi], axis=-1), jnp.float32)
        o, d = self._ray_fn(jnp.asarray(view_idx), coords)
        return Batch(origins=o, dirs=d, gold=jnp.asarray(gold))

    def close(self):
        self._stop.set()
        # drain so blocked producers can observe the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        for t in self._threads:
            t.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
