"""mip-NeRF IPE (models/encoding.integrated_posenc +
ops/sampling.conical_gaussians + the render_rays interval path):
moment closed forms vs exact integrals, PE-limit reduction, config
validation, and end-to-end training."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nerf_rs_tpu.config import (
    CameraConfig, Config, ModelConfig, RenderConfig, TrainConfig,
)
from nerf_rs_tpu.models import encoding
from nerf_rs_tpu.models.mlp import init_nerf_params
from nerf_rs_tpu.ops import render, sampling


def test_ipe_reduces_to_posenc_at_zero_var():
    x = jax.random.normal(jax.random.PRNGKey(0), (5, 3))
    for include in (True, False):
        pe = encoding.posenc(x, 4, include)
        ipe = encoding.integrated_posenc(x, jnp.zeros_like(x), 4, include)
        np.testing.assert_allclose(np.asarray(ipe), np.asarray(pe),
                                   atol=1e-6)
        assert ipe.shape[-1] == encoding.posenc_dim(3, 4, include)


def test_ipe_damps_high_frequencies():
    """With nonzero variance the damped encoding must shrink, and the
    highest frequency must shrink the most (exp(-4^l var / 2))."""
    x = jnp.ones((1, 3)) * 0.3
    L = 6
    pe = np.abs(np.asarray(encoding.posenc(x, L, False))).reshape(L, 6)
    ipe = np.abs(np.asarray(
        encoding.integrated_posenc(x, jnp.full((1, 3), 0.05), L, False)
    )).reshape(L, 6)
    ratios = (ipe.sum(-1) + 1e-12) / (pe.sum(-1) + 1e-12)
    assert (ratios <= 1.0 + 1e-6).all()
    assert ratios[-1] < ratios[0]  # finest level most attenuated
    assert ratios[-1] < 1e-3  # 2^5-frequency effectively zeroed


def test_conical_t_mean_matches_exact_integral():
    """t_mean must equal the frustum's center of mass in t with density
    ~ t^2 (cone cross-section area): E[t] = (3/4)(t1^4-t0^4)/(t1^3-t0^3).
    The paper's mu + 2 mu hw^2/(3 mu^2 + hw^2) is the stable
    reparameterization of exactly this."""
    t0 = np.array([0.5, 1.0, 2.0, 3.7])
    t1 = np.array([0.9, 2.0, 2.1, 5.9])
    edges = jnp.asarray(np.stack([t0, t1], axis=-1))  # (4, 2) -> 1 interval
    o = jnp.zeros((4, 3))
    d = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (4, 1))
    mean, var, mids, deltas = sampling.conical_gaussians(o, d, edges, 0.01)
    exact = 0.75 * (t1**4 - t0**4) / (t1**3 - t0**3)
    np.testing.assert_allclose(np.asarray(mean[:, 0, 2]), exact, rtol=1e-5)
    assert (np.asarray(var) > 0).all()
    np.testing.assert_allclose(np.asarray(deltas[:, 0]), t1 - t0, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(mids[:, 0]), 0.5 * (t0 + t1),
                               rtol=1e-6)


def test_conical_var_split_axes():
    """Along-ray variance rides the direction axis; the perpendicular
    r_var rides the others (diagonal of eq. 16)."""
    edges = jnp.asarray([[1.0, 1.5]])
    o = jnp.zeros((1, 3))
    d = jnp.asarray([[0.0, 0.0, 1.0]])  # unit, along z
    _, var, _, _ = sampling.conical_gaussians(o, d, edges, 0.1)
    v = np.asarray(var[0, 0])
    assert v[0] == pytest.approx(v[1])  # isotropic perpendicular
    assert v[2] != pytest.approx(v[0])  # distinct along-ray term


MODEL = ModelConfig(net_depth=3, net_width=32, skip_layer=2,
                    feature_width=32, view_head_width=16,
                    pos_enc_levels=4, dir_enc_levels=2, ipe=True,
                    sigma_activation="softplus")


def _cfg(fine=0):
    return Config(
        camera=CameraConfig(width=32, height=32),
        model=MODEL,
        render=RenderConfig(num_samples=8, num_fine_samples=fine,
                            fine_mode="standalone", share_network=True),
        train=TrainConfig(num_rays=64, precision="f32"),
    )


def test_render_rays_ipe_shapes_and_hierarchy():
    cfg = _cfg(fine=12)
    params = init_nerf_params(jax.random.PRNGKey(0), cfg.model)
    o = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (16, 1))
    d = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (16, 1))
    coarse, fine = render.render_rays(
        params, o, d, jax.random.PRNGKey(1), cfg.model, cfg.render,
        cfg.camera,
    )
    assert coarse.rgb.shape == (16, 3)
    assert coarse.weights.shape == (16, 8)
    assert fine.weights.shape == (16, 12)  # standalone fine intervals
    assert fine.ts.shape == (16, 12)
    for out in (coarse, fine):
        assert np.isfinite(np.asarray(out.rgb)).all()
        # interval weights are a sub-probability measure
        assert (np.asarray(out.acc) <= 1.0 + 1e-5).all()


def test_ipe_config_validation():
    # round 4: union fine and occupancy-guided coarse edges are VALID
    # ipe compositions (interval-aware occupancy — occupancy_edges);
    # point-sample-only mechanisms (proposal, compat) stay rejected
    _cfg().replace(render=RenderConfig(
        num_samples=8, num_fine_samples=8, fine_mode="union"))
    Config(model=MODEL, render=RenderConfig(num_samples=8, occ_res=8))
    with pytest.raises(ValueError, match="arch"):
        Config(model=ModelConfig(ipe=True, arch="factored"))
    with pytest.raises(ValueError, match="interval"):
        from nerf_rs_tpu.config import ProposalConfig

        Config(model=MODEL, proposal=ProposalConfig(enabled=True))


def test_mipnerf_preset_cli():
    from nerf_rs_tpu.cli import build_parser, config_from_args

    args = build_parser().parse_args(
        ["train", "--preset", "mipnerf", "--dataset", "sphere"]
    )
    cfg = config_from_args(args)
    assert cfg.model.ipe
    assert cfg.render.share_network
    assert cfg.render.fine_mode == "standalone"
    assert cfg.render.num_fine_samples == 128


def test_scaled_camera_widens_footprint():
    """Multiscale eval (cli eval --scales): the 1/s camera must widen
    the IPE cone base radius by exactly s, for both fov-derived and
    explicit-focal cameras."""
    from nerf_rs_tpu.data.device_dataset import DeviceDataset

    imgs = np.zeros((2, 16, 16, 4), np.uint8)
    for cam in (CameraConfig(width=16, height=16),
                CameraConfig(width=16, height=16, focal=20.0)):
        ds = DeviceDataset(imgs, cam, angles=np.zeros((2, 2), np.float32))
        r1 = sampling.pixel_radius(cam)
        r4 = sampling.pixel_radius(ds.scaled_camera(4))
        assert r4 == pytest.approx(4.0 * r1, rel=1e-6)
        o, d = ds.view_rays(0, scale=4)
        assert o.shape == (4, 4, 3)


def test_view_gold_box_downsample():
    from nerf_rs_tpu.data.device_dataset import DeviceDataset

    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 255, (1, 8, 8, 4), dtype=np.uint8)
    imgs[..., 3] = 255
    cam = CameraConfig(width=8, height=8)
    ds = DeviceDataset(imgs, cam, angles=np.zeros((1, 2), np.float32))
    full = np.asarray(ds.view_gold(0))
    half = np.asarray(ds.view_gold(0, scale=2))
    assert half.shape == (4, 4, 3)
    np.testing.assert_allclose(
        half[0, 0], full[:2, :2].mean(axis=(0, 1)), rtol=1e-6)
    np.testing.assert_allclose(half.mean(), full.mean(), rtol=1e-6)


def test_multiscale_render_matches_block_mean_better():
    """The anti-aliasing claim in miniature: render an UNTRAINED but
    fixed random field at 1/2 scale; the scaled camera must at least
    produce the right shapes and finite output through render_rays
    (the quality comparison needs a trained field on the card)."""
    cfg = _cfg()
    params = init_nerf_params(jax.random.PRNGKey(3), cfg.model)
    from nerf_rs_tpu.data.device_dataset import DeviceDataset

    imgs = np.zeros((1, 32, 32, 4), np.uint8)
    ds = DeviceDataset(imgs, cfg.camera, angles=np.zeros((1, 2), np.float32))
    o, d = ds.view_rays(0, scale=2)
    out, _ = render.render_rays(
        params, o.reshape(-1, 3), d.reshape(-1, 3), jax.random.PRNGKey(0),
        cfg.model, cfg.render, ds.scaled_camera(2), randomized=False,
    )
    assert out.rgb.shape == (16 * 16, 3)
    assert np.isfinite(np.asarray(out.rgb)).all()


@pytest.mark.slow
def test_ipe_training_descends():
    """The IPE path must train end-to-end through loss_fn/train_step."""
    from nerf_rs_tpu.data import synthetic
    from nerf_rs_tpu.ops import rays
    from nerf_rs_tpu.train import Batch, init_state, train_step

    cfg = _cfg(fine=8)
    key = jax.random.PRNGKey(0)
    state = init_state(key, cfg)
    img = synthetic.sphere_image(cfg.camera)
    coords = jax.random.uniform(jax.random.PRNGKey(1), (64, 2)) * 31.0
    o, d = rays.rays_for_coords(coords, None, cfg.camera)
    gold = img[coords[:, 1].astype(jnp.int32),
               coords[:, 0].astype(jnp.int32), :3]
    batch = Batch(o, d, gold)
    losses = []
    for i in range(80):
        state, aux = train_step(state, batch, jax.random.fold_in(key, i),
                                cfg)
        losses.append(float(aux["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.5 * losses[0]
