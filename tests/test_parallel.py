"""Multi-device tests on the 8 virtual CPU devices (conftest.py):
DP train step equivalence vs single-device, sharded rendering parity,
mesh helpers. This is the shard_map/psum coverage SURVEY §4 calls for."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

from nerf_rs_tpu.config import CameraConfig, Config, ModelConfig, RenderConfig, TrainConfig
from nerf_rs_tpu.data import synthetic
from nerf_rs_tpu.ops import rays, render
from nerf_rs_tpu.parallel import dp, mesh as mesh_mod
from nerf_rs_tpu.train import Batch, init_state, train_step


def _cfg(**train_kw):
    return Config(
        camera=CameraConfig(width=32, height=32),
        model=ModelConfig(
            net_depth=3, net_width=32, skip_layer=2, feature_width=32,
            view_head_width=16, pos_enc_levels=4, dir_enc_levels=2,
        ),
        render=RenderConfig(num_samples=16),
        train=TrainConfig(num_rays=256, precision="f32", **train_kw),
    )


def _batch(key, cfg, n):
    coords = jax.random.uniform(key, (n, 2)) * 31.0
    o, d = rays.rays_for_coords(coords, None, cfg.camera)
    img = synthetic.sphere_image(cfg.camera)
    gold = img[
        coords[:, 1].astype(jnp.int32), coords[:, 0].astype(jnp.int32), :3
    ]
    return Batch(o, d, gold)


def test_mesh_helpers():
    m = mesh_mod.make_mesh()
    assert mesh_mod.num_shards(m) == 8
    assert mesh_mod.pad_to_shards(13, m) == 16
    m2 = mesh_mod.make_mesh(4)
    assert mesh_mod.num_shards(m2) == 4


def test_default_render_chunk_scales_with_samples():
    # measured-good point: 64 coarse samples -> 65536 rays
    assert dp.default_render_chunk(RenderConfig(num_samples=64)) == 65536
    # union 64+128 holds (chunk, 192, W) temps -> 3x fewer rays, pow2
    hier = RenderConfig(num_samples=64, num_fine_samples=128)
    assert dp.default_render_chunk(hier) == 16384
    # standalone passes run sequentially: peak is max(S, F), not S+F
    st = RenderConfig(num_samples=64, num_fine_samples=128,
                      fine_mode="standalone")
    assert dp.default_render_chunk(st) == 32768
    # tiny test configs never fall below the floor
    assert dp.default_render_chunk(RenderConfig(num_samples=8)) == 65536


def test_default_render_chunk_flat_hashgrid_scales_down():
    # flat-layout hash gathers materialize 8 corner rows per (point,
    # level), so its render chunk gets an 8x smaller ray-sample budget:
    # the 4096 x 128 shape training runs at
    from nerf_rs_tpu.config import ModelConfig

    r128 = RenderConfig(num_samples=128)
    flat = ModelConfig(arch="hashgrid", hash_brick=False)
    brick = ModelConfig(arch="hashgrid", hash_brick=True)
    assert dp.default_render_chunk(r128, model_cfg=flat) == 4096
    # brick rows are one aligned gather per (point, level): full budget
    assert dp.default_render_chunk(r128, model_cfg=brick) == 32768
    # MLP families unaffected
    assert dp.default_render_chunk(r128, model_cfg=ModelConfig()) == 32768


def test_dp_step_runs_and_updates():
    cfg = _cfg()
    m = mesh_mod.make_mesh()
    state = dp.place_state(init_state(jax.random.PRNGKey(0), cfg), m)
    step_fn = dp.make_dp_train_step(cfg, m)
    batch = dp.place_batch(_batch(jax.random.PRNGKey(1), cfg, 256), m)
    p0 = np.asarray(state.params["trunk"][0]["w"])
    state, aux = step_fn(state, batch, jax.random.PRNGKey(2))
    assert np.isfinite(float(aux["loss"]))
    assert int(state.step) == 1
    delta = np.abs(np.asarray(state.params["trunk"][0]["w"]) - p0).max()
    assert delta > 0


def test_dp_grads_match_single_device():
    """With per-shard keys pmean'd grads differ from single-device only
    through sampling RNG; force determinism by midpoint sampling so the
    DP step must numerically match the single-device step."""
    cfg = _cfg()
    cfg = cfg.replace(render=RenderConfig(num_samples=16, randomized=False))
    m = mesh_mod.make_mesh()
    key = jax.random.PRNGKey(0)
    batch = _batch(jax.random.PRNGKey(1), cfg, 256)

    s_single = init_state(key, cfg)
    s_single, aux_single = train_step(s_single, batch, jax.random.PRNGKey(2), cfg)

    s_dp = dp.place_state(init_state(key, cfg), m)
    step_fn = dp.make_dp_train_step(cfg, m)
    s_dp, aux_dp = step_fn(s_dp, dp.place_batch(batch, m), jax.random.PRNGKey(2))

    np.testing.assert_allclose(
        float(aux_single["loss"]), float(aux_dp["loss"]), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(s_single.params["trunk"][0]["w"]),
        np.asarray(s_dp.params["trunk"][0]["w"]),
        atol=2e-5,
    )


def test_dp_grads_match_single_device_factored():
    """The factored family's DP step (XLA path through the same
    make_dp_train_step) must match the single-device step numerically,
    like the paper-MLP test above."""
    cfg = Config(
        camera=CameraConfig(width=32, height=32),
        model=ModelConfig(arch="factored", fac_levels=3, fac_base_res=4,
                          fac_max_res=16, fac_comps=8, fac_aabb=1.2,
                          sigma_activation="softplus"),
        render=RenderConfig(num_samples=16, randomized=False),
        train=TrainConfig(num_rays=256, precision="f32",
                          learning_rate=1e-2),
    )
    m = mesh_mod.make_mesh()
    key = jax.random.PRNGKey(0)
    batch = _batch(jax.random.PRNGKey(1), cfg, 256)

    s_single = init_state(key, cfg)
    s_single, aux_single = train_step(
        s_single, batch, jax.random.PRNGKey(2), cfg)

    s_dp = dp.place_state(init_state(key, cfg), m)
    step_fn = dp.make_dp_train_step(cfg, m)
    s_dp, aux_dp = step_fn(s_dp, dp.place_batch(batch, m),
                           jax.random.PRNGKey(2))

    np.testing.assert_allclose(
        float(aux_single["loss"]), float(aux_dp["loss"]), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(s_single.params["lines"]),
        np.asarray(s_dp.params["lines"]),
        atol=2e-5)


def test_single_device_mesh_matches_plain_step():
    """A 1-device mesh takes the plain-jit fast path (no shard_map
    wrapper and its dispatch overhead); it must be numerically
    identical to the single-device train_step."""
    cfg = _cfg()
    cfg = cfg.replace(render=RenderConfig(num_samples=16, randomized=False))
    m1 = mesh_mod.make_mesh(1)
    batch = _batch(jax.random.PRNGKey(1), cfg, 256)

    s_plain = init_state(jax.random.PRNGKey(0), cfg)
    s_plain, aux_plain = train_step(s_plain, batch, jax.random.PRNGKey(2), cfg)

    s1 = dp.place_state(init_state(jax.random.PRNGKey(0), cfg), m1)
    step_fn = dp.make_dp_train_step(cfg, m1)
    s1, aux1 = step_fn(s1, dp.place_batch(batch, m1), jax.random.PRNGKey(2))

    np.testing.assert_allclose(
        float(aux_plain["loss"]), float(aux1["loss"]), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(s_plain.params["trunk"][0]["w"]),
        np.asarray(s1.params["trunk"][0]["w"]),
        atol=1e-6,
    )


def test_dp_training_converges():
    cfg = _cfg(learning_rate=5e-3)
    m = mesh_mod.make_mesh()
    state = dp.place_state(init_state(jax.random.PRNGKey(0), cfg), m)
    step_fn = dp.make_dp_train_step(cfg, m)
    losses = []
    for i in range(60):
        k = jax.random.fold_in(jax.random.PRNGKey(1), i)
        batch = dp.place_batch(_batch(k, cfg, 256), m)
        state, aux = step_fn(state, batch, jax.random.fold_in(k, 5))
        losses.append(float(aux["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) * 0.8


def test_sharded_render_matches_unsharded():
    cfg = _cfg()
    cfg = cfg.replace(
        render=RenderConfig(num_samples=16, randomized=False),
    )
    m = mesh_mod.make_mesh()
    state = init_state(jax.random.PRNGKey(0), cfg)
    o, d = rays.ray_grid(None, cfg.camera)
    flat_o, flat_d = o.reshape(-1, 3), d.reshape(-1, 3)

    render_fn = dp.make_dp_render(cfg, m)
    rgb_s, depth_s, acc_s = render_fn(
        state.params, state.params, flat_o, flat_d, jax.random.PRNGKey(3)
    )

    coarse, _ = render.render_rays(
        state.params, flat_o, flat_d, jax.random.PRNGKey(3),
        cfg.model, cfg.render, cfg.camera, randomized=False,
    )
    np.testing.assert_allclose(
        np.asarray(rgb_s), np.asarray(coarse.rgb), atol=1e-5
    )


def test_dp_accumulation_runs():
    cfg = _cfg(accumulation_steps=2)
    m = mesh_mod.make_mesh()
    state = dp.place_state(init_state(jax.random.PRNGKey(0), cfg), m)
    step_fn = dp.make_dp_train_step(cfg, m)
    batch = dp.place_batch(_batch(jax.random.PRNGKey(1), cfg, 256), m)
    state, aux = step_fn(state, batch, jax.random.PRNGKey(2))
    assert np.isfinite(float(aux["loss"]))


def test_dp_error_resample_fused_in_step():
    """Error-weighted sampling fused INTO the sharded step (dp._step_err):
    the store rides the step as a device arg, every shard applies the
    identical all-gathered EMA scatter, and the copies never diverge."""
    from nerf_rs_tpu.data import synthetic
    from nerf_rs_tpu.data.device_dataset import DeviceDataset
    from nerf_rs_tpu.ops import rays as rays_ops

    cfg = _cfg(error_resample_frac=0.5)
    m = mesh_mod.make_mesh()
    imgs = np.asarray(synthetic.sphere_scene_images(cfg.camera, 16))
    angles = np.asarray(rays_ops.view_angle_grid(6))[:16]
    ds = DeviceDataset(imgs, cfg.camera, angles=angles,
                       sharding=mesh_mod.replicated_sharding(m))
    state = dp.place_state(init_state(jax.random.PRNGKey(0), cfg), m)
    err = jax.device_put(ds.init_error_store(),
                         mesh_mod.replicated_sharding(m))
    fn = dp.make_dp_train_step(cfg, m, dataset=ds)
    state, aux, err2 = fn(state, ds.images, ds.pose_data, err,
                          jax.random.PRNGKey(1))
    assert np.isfinite(float(aux["loss"]))
    # the visited pixels' entries moved off the optimistic init...
    e2 = np.asarray(jax.device_get(err2))
    idx = np.asarray(jax.device_get(aux["batch_idx"]))
    assert not np.allclose(e2[idx], 1.0)
    # ...untouched pixels kept it
    mask = np.ones(e2.shape[0], bool)
    mask[idx] = False
    np.testing.assert_array_equal(e2[mask], 1.0)
    # and every device holds the same store
    shards = [np.asarray(s.data) for s in err2.addressable_shards]
    for s in shards[1:]:
        np.testing.assert_array_equal(shards[0], s)
    # second step threads the new store without re-placement
    state, aux, err3 = fn(state, ds.images, ds.pose_data, err2,
                          jax.random.PRNGKey(2))
    assert int(jax.device_get(state.step)) == 2


@pytest.mark.slow
def test_flagship_width_dp_step():
    """The FULL flagship model (8x256+skip, PE 10/4) compiles and runs
    one DP step across all 8 virtual devices — the exact program shape
    the real multi-chip deployment uses (~15 s on CPU)."""
    cfg = Config(
        camera=CameraConfig(),
        model=ModelConfig(),
        render=RenderConfig(num_samples=64),
        train=TrainConfig(num_rays=512, precision="mixed"),
    )
    m = mesh_mod.make_mesh()
    state = dp.place_state(init_state(jax.random.PRNGKey(0), cfg), m)
    step_fn = dp.make_dp_train_step(cfg, m)
    b = Batch(
        jnp.zeros((512, 3)).at[:, 2].set(-1.0),
        jnp.zeros((512, 3)).at[:, 2].set(1.0),
        jnp.full((512, 3), 0.5),
    )
    state, aux = step_fn(state, dp.place_batch(b, m), jax.random.PRNGKey(1))
    assert np.isfinite(float(aux["loss"]))
    assert int(jax.device_get(state.step)) == 1

