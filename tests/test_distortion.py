"""Distortion loss (mip-NeRF 360 eq. 15): O(S) prefix-sum form vs the
brute-force double sum, and the loss_fn/CLI wiring."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nerf_rs_tpu.config import (
    CameraConfig, Config, ModelConfig, RenderConfig, TrainConfig,
)
from nerf_rs_tpu.models.mlp import init_nerf_params
from nerf_rs_tpu.ops import render, sampling

CFG = ModelConfig(net_depth=4, net_width=32, skip_layer=2,
                  feature_width=32, view_head_width=16,
                  pos_enc_levels=3, dir_enc_levels=1)
S, N = 8, 16
NEAR, FAR = 0.1, 2.0


def _brute_force(w, ts, near, far):
    """O(S^2) double sum straight off the paper equation."""
    span = far - near
    s = (np.asarray(ts) - near) / span
    d = np.asarray(sampling.deltas_from_ts(jnp.asarray(ts), far)) / span
    w = np.asarray(w)
    total = 0.0
    for r in range(w.shape[0]):
        inner = 0.0
        for i in range(w.shape[1]):
            for j in range(w.shape[1]):
                inner += w[r, i] * w[r, j] * abs(s[r, i] - s[r, j])
        total += inner + (w[r] ** 2 * d[r]).sum() / 3.0
    return total / w.shape[0]


def test_matches_brute_force():
    key = jax.random.PRNGKey(0)
    kw, kt = jax.random.split(key)
    w = jax.random.uniform(kw, (6, 12)) * 0.3
    ts = jnp.sort(jax.random.uniform(kt, (6, 12)) * 1.7 + NEAR, axis=-1)
    fast = float(render.distortion_loss(w, ts, NEAR, FAR))
    slow = _brute_force(w, ts, NEAR, FAR)
    np.testing.assert_allclose(fast, slow, rtol=1e-5)


def test_concentrated_beats_spread():
    """A ray with all weight on one sample must score (much) lower than
    the same mass spread across the ray — the property the regularizer
    exists for."""
    ts = jnp.linspace(NEAR, FAR, 16)[None, :]
    spread = jnp.full((1, 16), 1.0 / 16.0)
    point = jnp.zeros((1, 16)).at[0, 8].set(1.0)
    l_spread = float(render.distortion_loss(spread, ts, NEAR, FAR))
    l_point = float(render.distortion_loss(point, ts, NEAR, FAR))
    assert l_point < 0.2 * l_spread


def _data(key):
    ko, kd, kt, kg = jax.random.split(key, 4)
    o = jax.random.normal(ko, (N, 3)) * 0.1
    o = o.at[:, 2].add(-1.0)
    d = jax.random.normal(kd, (N, 3)) * 0.05
    d = d.at[:, 2].add(1.0)
    vd = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    ts = jnp.sort(jax.random.uniform(kt, (N, S)) * 1.8 + 0.05, axis=-1)
    deltas = sampling.deltas_from_ts(ts, FAR)
    gold = jax.random.uniform(kg, (N, 3))
    return o, d, vd, ts, deltas, gold


def test_loss_fn_wiring():
    """loss_fn reports loss_dist and folds it into the total, for both
    coarse-only and hierarchical configs."""
    from nerf_rs_tpu.train.step import Batch, loss_fn

    for fine in (0, 6):
        cfg = Config(
            camera=CameraConfig(width=8, height=8, near=NEAR, far=FAR),
            model=CFG,
            render=RenderConfig(num_samples=S, num_fine_samples=fine,
                                share_network=True),
            train=TrainConfig(num_rays=N, distortion_weight=0.1,
                              precision="f32"),
        )
        params = init_nerf_params(jax.random.PRNGKey(0), cfg.model)
        o, d, vd, ts, deltas, gold = _data(jax.random.PRNGKey(1))
        batch = Batch(origins=o, dirs=d, gold=gold,
                      idx=jnp.zeros((N,), jnp.int32))
        loss, aux = loss_fn(params, batch, jax.random.PRNGKey(2), cfg)
        assert "loss_dist" in aux and np.isfinite(float(aux["loss_dist"]))
        base = (aux["loss_coarse"] + aux.get("loss_fine", 0.0))
        np.testing.assert_allclose(
            float(loss), float(base + 0.1 * aux["loss_dist"]), rtol=1e-6)


@pytest.mark.slow
def test_dp_step_with_distortion():
    """make_dp_train_step's aux spec must carry loss_dist over the
    8-virtual-device mesh (shard_map out_specs enumerate aux keys)."""
    from nerf_rs_tpu.ops import rays
    from nerf_rs_tpu.data import synthetic
    from nerf_rs_tpu.parallel import dp, mesh as mesh_mod
    from nerf_rs_tpu.train import init_state
    from nerf_rs_tpu.train.step import Batch

    cfg = Config(
        camera=CameraConfig(width=32, height=32, near=NEAR, far=FAR),
        model=CFG,
        render=RenderConfig(num_samples=S),
        train=TrainConfig(num_rays=256, precision="f32",
                          distortion_weight=0.01),
    )
    m = mesh_mod.make_mesh()
    state = dp.place_state(init_state(jax.random.PRNGKey(0), cfg), m)
    coords = jax.random.uniform(jax.random.PRNGKey(1), (256, 2)) * 31.0
    o, d = rays.rays_for_coords(coords, None, cfg.camera)
    img = synthetic.sphere_image(cfg.camera)
    gold = img[coords[:, 1].astype(jnp.int32),
               coords[:, 0].astype(jnp.int32), :3]
    batch = dp.place_batch(Batch(o, d, gold), m)
    step_fn = dp.make_dp_train_step(cfg, m)
    state, aux = step_fn(state, batch, jax.random.PRNGKey(2))
    assert "loss_dist" in aux
    assert np.isfinite(float(aux["loss_dist"]))
    assert np.isfinite(float(aux["loss"]))

