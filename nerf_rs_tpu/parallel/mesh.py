"""Device mesh + sharding helpers.

The reference has no parallelism of any kind (SURVEY §2.12-bis: one
thread, one Metal GPU). The scaling story (SURVEY §5.8) is a 1-D mesh
over the 'data' axis: ray batches sharded per device, params replicated
(the MLP is ~2.4 MB — pure DP, no FSDP/TP needed), psum gradient sync
over the device interconnect. Full-frame renders shard pixel tiles over
the same axis.

Multi-host: call jax.distributed.initialize() before make_mesh() (see
parallel/dist_init.py); the mesh then spans all processes' devices.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
SCENE_AXIS = "scene"


def make_scene_mesh(
    n_scenes: int, num_devices: int = 0, devices=None
) -> Mesh:
    """2-D (scene, data) mesh for multi-scene training.

    Scene groups advance independent scenes (zero cross-group
    collectives); within a group, rays are data-parallel with grad
    psum. scene_shards = gcd(n_scenes, n_devices) so any scene count
    maps onto any device count: 2 scenes on 4 devices -> (2, 2) — each
    scene gets a 2-device DP group; 3 scenes on 4 devices -> (1, 4) —
    every device holds all scenes vmapped, rays split 4 ways.
    """
    import math

    if devices is None:
        devices = jax.devices()
    if num_devices and num_devices > 0:
        assert num_devices <= len(devices), (
            f"requested {num_devices} devices, have {len(devices)}"
        )
        devices = devices[:num_devices]
    ndev = len(devices)
    scene_shards = math.gcd(n_scenes, ndev)
    return Mesh(
        np.asarray(devices).reshape(scene_shards, ndev // scene_shards),
        (SCENE_AXIS, DATA_AXIS),
    )


def make_mesh(num_devices: int = 0, devices=None) -> Mesh:
    """1-D data-parallel mesh over the first ``num_devices`` devices
    (0 = all). Works identically for 1 GPU, 4 GPUs, or 8 virtual CPU
    devices in tests."""
    if devices is None:
        devices = jax.devices()
    if num_devices and num_devices > 0:
        assert num_devices <= len(devices), (
            f"requested {num_devices} devices, have {len(devices)}"
        )
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def batch_spec() -> P:
    """Rays sharded along the data axis."""
    return P(DATA_AXIS)


def replicated_spec() -> P:
    return P()


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def view_sharding(mesh: Mesh) -> NamedSharding:
    """Pixel store sharded on its leading (view) axis — the
    DataConfig.shard_pixel_store layout."""
    return NamedSharding(mesh, P(DATA_AXIS))


def num_shards(mesh: Mesh) -> int:
    return mesh.shape[DATA_AXIS]


def pad_to_shards(n: int, mesh: Mesh) -> int:
    """Smallest multiple of the mesh size >= n (batches must divide
    evenly across shards)."""
    k = num_shards(mesh)
    return ((n + k - 1) // k) * k
