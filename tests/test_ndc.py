"""NDC ray reparameterization (ops/rays.ndc_rays, NeRF paper appendix
C / forward-facing LLFF mode): projective correctness, depth-range
bounds, config validation, the maybe_ndc hook through the dataset
samplers, and an end-to-end fit on the forward-facing procedural scene."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nerf_rs_tpu.config import (
    CameraConfig, Config, DataConfig, ModelConfig, RenderConfig, TrainConfig,
)
from nerf_rs_tpu.ops import rays as rays_ops


CAM = CameraConfig(width=64, height=48, near=0.0, far=1.0, ndc=True,
                   ndc_near=1.0, fov=0.8)


def _frustum_rays(key, n=64):
    """Random rays from cameras near the origin looking toward -z."""
    ko, kd = jax.random.split(key)
    o = jax.random.uniform(ko, (n, 3), minval=-0.2, maxval=0.2)
    d = jax.random.uniform(kd, (n, 3), minval=-0.25, maxval=0.25)
    d = d.at[:, 2].set(-1.0)
    return o, d


def _project(p, camera):
    """The NDC projection pi(x,y,z) the warp must be consistent with."""
    focal = 0.5 * camera.width / math.tan(0.5 * camera.fov)
    n = camera.ndc_near
    return np.stack([
        -focal / (0.5 * camera.width) * p[..., 0] / p[..., 2],
        -focal / (0.5 * camera.height) * p[..., 1] / p[..., 2],
        1.0 + 2.0 * n / p[..., 2],
    ], axis=-1)


def test_ndc_points_are_projected_world_points():
    """o' + s d' for any s in [0,1] must equal pi(world point on the
    same ray): the warp IS the projective map restricted to the ray."""
    o, d = _frustum_rays(jax.random.PRNGKey(0))
    o_n, d_n = rays_ops.ndc_rays(o, d, CAM)
    o_n, d_n = np.asarray(o_n), np.asarray(d_n)
    o, d = np.asarray(o), np.asarray(d)
    # world point at the plane z = -ndc_near (the s=0 anchor)
    t0 = -(CAM.ndc_near + o[:, 2]) / d[:, 2]
    for s in (0.0, 0.15, 0.5, 0.9):
        p_ndc = o_n + s * d_n
        # invert the z'-mapping to find the world z this s refers to
        z = 2.0 * CAM.ndc_near / (p_ndc[:, 2] - 1.0)
        t = (z - o[:, 2]) / d[:, 2]
        assert (t >= t0 - 1e-4).all()  # in front of the near plane
        p_world = o + t[:, None] * d
        np.testing.assert_allclose(p_ndc, _project(p_world, CAM),
                                   rtol=1e-4, atol=1e-5)


def test_ndc_depth_range_and_monotonicity():
    o, d = _frustum_rays(jax.random.PRNGKey(1))
    o_n, d_n = rays_ops.ndc_rays(o, d, CAM)
    z0 = np.asarray(o_n[:, 2])
    z1 = np.asarray(o_n[:, 2] + d_n[:, 2])
    # s=0 sits at world z=-near -> NDC z=-1; s=1 is the z=-inf limit
    np.testing.assert_allclose(z0, -1.0, atol=1e-5)
    np.testing.assert_allclose(z1, 1.0, atol=1e-5)
    assert (np.asarray(d_n[:, 2]) > 0).all()  # depth strictly increasing


def test_ndc_frustum_maps_into_unit_square():
    """Rays through the image grid of an on-axis camera map x/y into
    [-1, 1] all along the ray."""
    cam = CameraConfig(width=32, height=32, near=0.0, far=1.0, ndc=True)
    # canonical camera looks toward +z (reference convention) — build a
    # -z-facing pose via the Blender c2w identity
    c2w = jnp.eye(4)
    o, d = rays_ops.ray_grid_c2w(c2w, 32, 32, focal=cam.focal or
                                 0.5 * 32 / math.tan(0.5 * cam.fov))
    o_n, d_n = rays_ops.ndc_rays(o.reshape(-1, 3), d.reshape(-1, 3), cam)
    for s in (0.0, 0.5, 1.0):
        p = np.asarray(o_n + s * d_n)
        assert (np.abs(p[:, :2]) <= 1.0 + 1e-4).all()


def test_maybe_ndc_hook_and_sampler():
    """The dataset sampler must emit NDC rays when camera.ndc is set:
    origins on the z'=-1 plane, dirs with positive NDC depth."""
    from nerf_rs_tpu.data.device_dataset import DeviceDataset

    imgs = np.zeros((2, 16, 16, 4), np.uint8)
    c2w = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    cam = CameraConfig(width=16, height=16, near=0.0, far=1.0, ndc=True,
                       focal=20.0)
    ds = DeviceDataset(imgs, cam, c2w=c2w)
    batch = ds.sample_batch(jax.random.PRNGKey(0), 32)
    np.testing.assert_allclose(np.asarray(batch.origins[:, 2]), -1.0,
                               atol=1e-5)
    assert (np.asarray(batch.dirs[:, 2]) > 0).all()
    o, d = ds.view_rays(0)
    np.testing.assert_allclose(np.asarray(o[..., 2]), -1.0, atol=1e-5)


def test_ndc_config_validation():
    with pytest.raises(ValueError, match="near 0"):
        Config(camera=CameraConfig(ndc=True, near=0.05, far=2.0))
    with pytest.raises(ValueError, match="ipe"):
        Config(camera=CameraConfig(ndc=True, near=0.0, far=1.0),
               model=ModelConfig(ipe=True))
    ok = Config(camera=CameraConfig(ndc=True, near=0.0, far=1.0))
    assert ok.camera.ndc


def test_ndc_cli_auto_near_far():
    from nerf_rs_tpu.cli import build_parser, config_from_args
    from nerf_rs_tpu.cli import main as cli_main  # noqa: F401 (import check)

    import nerf_rs_tpu.cli as cli

    args = cli.build_parser().parse_args(
        ["train", "--ndc", "true", "--dataset", "sphere"])
    args._explicit = {"ndc"}
    args = cli._apply_preset(args)
    cfg = config_from_args(args)
    assert cfg.camera.ndc and cfg.camera.near == 0.0 and cfg.camera.far == 1.0
    # explicit near/far still win (and then fail validation, loudly)
    args2 = cli.build_parser().parse_args(
        ["train", "--ndc", "true", "--near", "0.3", "--dataset", "sphere"])
    args2._explicit = {"ndc", "near"}
    args2 = cli._apply_preset(args2)
    with pytest.raises(ValueError, match="near 0"):
        config_from_args(args2)


@pytest.mark.slow
def test_ndc_training_fits_forward_facing_scene(tmp_path):
    """End-to-end: generate a tiny forward-facing procedural scene,
    train with --ndc, and check the loss collapses (the field is
    learnable in NDC coordinates)."""
    from nerf_rs_tpu.data.procedural import make_blender_scene
    from nerf_rs_tpu.data.factory import make_dataset
    from nerf_rs_tpu.train import init_state, train_step

    scene_dir = str(tmp_path / "facing")
    make_blender_scene(scene_dir, size=32, n_train=6, n_val=1, n_test=2,
                       num_samples=96, verbose=False, scene="facing")
    cfg = Config(
        camera=CameraConfig(width=32, height=32, near=0.0, far=1.0,
                            ndc=True),
        model=ModelConfig(net_depth=3, net_width=48, skip_layer=2,
                          feature_width=48, view_head_width=24,
                          pos_enc_levels=6, dir_enc_levels=2),
        render=RenderConfig(num_samples=48, white_background=True),
        train=TrainConfig(num_rays=256, precision="f32",
                          learning_rate=2e-3),
        data=DataConfig(dataset="blender", img_dir=scene_dir),
    )
    ds = make_dataset(cfg)
    key = jax.random.PRNGKey(0)
    state = init_state(key, cfg)
    losses = []
    for i in range(150):
        batch = ds.sample_batch(jax.random.fold_in(key, i), 256)
        state, aux = train_step(state, batch,
                                jax.random.fold_in(key, 10_000 + i), cfg)
        losses.append(float(aux["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < 0.25 * np.mean(losses[:10])
