"""Multiscale training (DataConfig.multiscale_levels, mip-NeRF
arXiv 2103.13415 §4): pyramid store correctness vs view_gold, the
level-partitioned per-ray sampler with per-ray cone radii, the radii
path through render_rays, DP integration on the 8-device mesh, and
config validation."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nerf_rs_tpu.config import (
    CameraConfig, Config, DataConfig, ModelConfig, RenderConfig, TrainConfig,
)
from nerf_rs_tpu.data.device_dataset import (
    DeviceDataset, _sample_per_ray_ms, build_pyramid,
)
from nerf_rs_tpu.ops import sampling


def _imgs(v=3, h=16, w=16, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 255, (v, h, w, 4), dtype=np.uint8)
    return imgs


def _ds(imgs, levels, white_bg=False, cam=None):
    cam = cam or CameraConfig(width=imgs.shape[2], height=imgs.shape[1])
    return DeviceDataset(
        imgs, cam, angles=np.zeros((imgs.shape[0], 2), np.float32),
        white_background=white_bg, multiscale_levels=levels,
    )


@pytest.mark.parametrize("white_bg", [False, True])
def test_pyramid_matches_view_gold(white_bg):
    """Every pyramid level's stored gold must equal view_gold(v, scale)
    up to uint8 rounding, in both background modes (the pyramid
    composites alpha FIRST, then box-averages — view_gold's order)."""
    imgs = _imgs()
    ds = _ds(imgs, levels=3, white_bg=white_bg)
    assert len(ds.ms_images) == 3
    for lvl in (1, 2):
        scale = 1 << lvl
        ref = np.asarray(ds.view_gold(1, scale=scale))
        store = np.asarray(ds.ms_images[lvl][1]).astype(np.float32)
        got = store[..., :3] / 255.0
        if white_bg:  # stored alpha is solid -> gather returns rgb as-is
            assert (store[..., 3] == 255).all()
        np.testing.assert_allclose(got, ref, atol=1.0 / 255.0 + 1e-6)


def test_ms_sampler_partition_and_radii():
    imgs = _imgs(h=32, w=32)
    cam = CameraConfig(width=32, height=32)
    ds = _ds(imgs, levels=3, cam=cam)
    n = 96
    batch = _sample_per_ray_ms(
        ds.ms_images, ds.pose_data, jax.random.PRNGKey(0), n, ds.mode,
        False, cam, 32, 32, ds.num_views,
    )
    assert batch.origins.shape == (n, 3)
    assert batch.radii.shape == (n,)
    r0 = sampling.pixel_radius(cam)
    radii = np.asarray(batch.radii)
    # equal thirds: level l rays carry radius 2^l * r0
    np.testing.assert_allclose(radii[:32], r0, rtol=1e-6)
    np.testing.assert_allclose(radii[32:64], 2 * r0, rtol=1e-6)
    np.testing.assert_allclose(radii[64:], 4 * r0, rtol=1e-6)
    # gold values must come from the corresponding level store
    gold = np.asarray(batch.gold)
    assert np.isfinite(gold).all() and (0 <= gold).all() and (gold <= 1).all()
    # diagnostics ids live in the level-0 pixel namespace
    idx = np.asarray(batch.idx)
    assert (0 <= idx).all() and (idx < ds.num_views * 32 * 32).all()


def test_ms_gold_matches_store_lookup():
    """A sampled ray's gold must be exactly the pyramid texel it names."""
    imgs = _imgs(h=16, w=16)
    ds = _ds(imgs, levels=2)
    n = 64
    batch = _sample_per_ray_ms(
        ds.ms_images, ds.pose_data, jax.random.PRNGKey(3), n, ds.mode,
        False, ds.camera, 16, 16, ds.num_views,
    )
    idx = np.asarray(batch.idx)
    gold = np.asarray(batch.gold)
    # second half of the batch is level 1: corner ids are even coords
    lvl1 = np.asarray(ds.ms_images[1]).astype(np.float32) / 255.0
    for i in range(n // 2, n):
        v, rem = divmod(idx[i], 16 * 16)
        y0, x0 = divmod(rem, 16)
        assert y0 % 2 == 0 and x0 % 2 == 0
        np.testing.assert_allclose(
            gold[i], lvl1[v, y0 // 2, x0 // 2, :3], atol=1e-6)


def test_radii_flow_through_render_rays():
    """Per-ray radii must change the IPE rendering (wider cones damp
    the encoding), and leave the point-sampled path untouched."""
    from nerf_rs_tpu.models.mlp import init_nerf_params
    from nerf_rs_tpu.ops import render

    model = ModelConfig(net_depth=2, net_width=32, skip_layer=1,
                        feature_width=32, view_head_width=16,
                        pos_enc_levels=6, dir_enc_levels=2, ipe=True)
    rcfg = RenderConfig(num_samples=8)
    cam = CameraConfig(width=16, height=16)
    params = init_nerf_params(jax.random.PRNGKey(0), model)
    o = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (8, 1))
    d = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (8, 1))
    key = jax.random.PRNGKey(1)

    def run(radii, m=model):
        out, _ = render.render_rays(
            params, o, d, key, m, rcfg, cam, randomized=False, radii=radii)
        return np.asarray(out.rgb)

    base = run(None)
    same = run(jnp.full((8,), sampling.pixel_radius(cam)))
    wide = run(jnp.full((8,), 64.0 * sampling.pixel_radius(cam)))
    np.testing.assert_allclose(same, base, atol=1e-6)
    assert np.abs(wide - base).max() > 1e-4
    # point-sampled model: radii ignored entirely
    pt = dataclasses.replace(model, ipe=False)
    np.testing.assert_allclose(run(jnp.full((8,), 7.0), pt), run(None, pt),
                               atol=1e-7)


def test_ms_dp_step_on_mesh():
    """Multiscale in-step sampling through the sharded DP train step on
    the 8-device mesh: the pyramid tuple rides the shard_map arg spec,
    loss is finite, params update."""
    from nerf_rs_tpu.parallel import dp, mesh as mesh_mod
    from nerf_rs_tpu.train.step import init_state

    cfg = Config(
        camera=CameraConfig(width=16, height=16),
        model=ModelConfig(net_depth=2, net_width=32, skip_layer=1,
                          feature_width=32, view_head_width=16,
                          pos_enc_levels=4, dir_enc_levels=2, ipe=True,
                          sigma_activation="softplus"),
        render=RenderConfig(num_samples=8),
        train=TrainConfig(num_rays=128, precision="f32"),
        data=DataConfig(dataset="sphere", multiscale_levels=2),
    )
    mesh = mesh_mod.make_mesh()
    imgs = _imgs(v=8, h=16, w=16)
    ds = DeviceDataset(
        imgs, cfg.camera, angles=np.zeros((8, 2), np.float32),
        sharding=mesh_mod.replicated_sharding(mesh), multiscale_levels=2,
    )
    state = dp.place_state(init_state(jax.random.PRNGKey(0), cfg), mesh)
    step = dp.make_dp_train_step(cfg, mesh, dataset=ds)
    p0 = np.asarray(
        jax.device_get(state.params["trunk"][0]["w"]))
    state, aux = step(state, ds.train_store, ds.pose_data,
                      jax.random.PRNGKey(1))
    assert np.isfinite(float(aux["loss"]))
    assert aux["batch_idx"].shape == (128,)
    p1 = np.asarray(jax.device_get(state.params["trunk"][0]["w"]))
    assert np.abs(p1 - p0).max() > 0


def test_multiscale_config_validation():
    ok = Config(data=DataConfig(multiscale_levels=4))
    assert ok.data.multiscale_levels == 4
    with pytest.raises(ValueError, match="per_ray"):
        Config(data=DataConfig(multiscale_levels=2, batch_mode="host"))
    with pytest.raises(ValueError, match="error"):
        Config(data=DataConfig(multiscale_levels=2),
               train=TrainConfig(error_resample_frac=0.5))
    with pytest.raises(ValueError, match="shard"):
        Config(data=DataConfig(multiscale_levels=2, shard_pixel_store=True))


def test_multiscale_cli_flag():
    from nerf_rs_tpu.cli import build_parser, config_from_args

    args = build_parser().parse_args(
        ["train", "--preset", "mipnerf", "--dataset", "sphere",
         "--multiscale_levels", "4"])
    cfg = config_from_args(args)
    assert cfg.data.multiscale_levels == 4
    assert cfg.model.ipe
