"""Factored (CP multiresolution) architecture (models/factored.py):
encoding oracle vs numpy, gradient flow, trainer integration,
checkpoint round-trip, and CLI/preset wiring. The reference has one
fixed MLP (src/model.rs:45-93); this is the framework's gather-free
fast-field family.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nerf_rs_tpu.config import (
    CameraConfig,
    Config,
    ModelConfig,
    RenderConfig,
    TrainConfig,
)
from nerf_rs_tpu.models import factored
from nerf_rs_tpu.models.mlp import apply_nerf, init_nerf_params
from nerf_rs_tpu.train import Batch, init_state

CFG = ModelConfig(
    arch="factored", fac_levels=3, fac_base_res=4, fac_max_res=16,
    fac_comps=8, fac_aabb=1.0, sigma_activation="softplus",
)


def _numpy_encode(lines, pts, cfg):
    """Independent oracle: per axis, linear interp of every level's
    line at the point's coordinate, summed across levels (the dense
    line matrix mixes levels); CP product across axes."""
    res = factored.fac_resolutions(cfg)
    p = np.asarray(pts, np.float64)
    u = np.clip((p + cfg.fac_aabb) / (2 * cfg.fac_aabb), 0.0, 1.0)
    n = p.shape[0]
    enc = np.ones((n, cfg.fac_comps))
    lines = np.asarray(lines, np.float64)
    for a in range(3):
        feat = np.zeros((n, cfg.fac_comps))
        off = 0
        for r in res:
            pos = u[:, a] * r
            i0 = np.minimum(np.floor(pos).astype(int), r - 1)
            fr = pos - i0
            block = lines[a][off:off + r + 1]
            feat += (1 - fr)[:, None] * block[i0] + fr[:, None] * block[i0 + 1]
            off += r + 1
        enc *= feat
    return enc


def test_encode_matches_numpy_oracle():
    key = jax.random.PRNGKey(0)
    lines = jax.random.normal(key, (3, factored.basis_dim(CFG),
                                    CFG.fac_comps))
    pts = jax.random.uniform(jax.random.PRNGKey(1), (64, 3),
                             minval=-1.3, maxval=1.3)  # incl. clipped
    enc = factored.factored_encode(lines, pts, CFG)
    want = _numpy_encode(lines, pts, CFG)
    np.testing.assert_allclose(np.asarray(enc), want, rtol=2e-4,
                               atol=2e-5)


def test_hat_weights_partition_of_unity():
    """Each level's hat weights sum to 1 at any interior point (linear
    interpolation weights), so each level block of a row sums to 1."""
    u = jnp.linspace(0.01, 0.99, 17)
    w = factored.hat_weights(u, CFG)
    off = 0
    for r in factored.fac_resolutions(CFG):
        block = w[:, off:off + r + 1]
        np.testing.assert_allclose(np.asarray(block.sum(-1)), 1.0,
                                   atol=1e-5)
        # 2-hot: at most two nonzero entries per level per point
        assert int((np.asarray(block) > 1e-6).sum(-1).max()) <= 2
        off += r + 1


def test_encode_continuity():
    params = init_nerf_params(jax.random.PRNGKey(0), CFG)
    p = jax.random.uniform(jax.random.PRNGKey(1), (32, 3),
                           minval=-0.9, maxval=0.9)
    e1 = factored.factored_encode(params["lines"], p, CFG)
    e2 = factored.factored_encode(params["lines"], p + 1e-5, CFG)
    assert float(jnp.abs(e1 - e2).max()) < 1e-2


@pytest.mark.slow
def test_apply_shapes_and_grad_flow():
    params = init_nerf_params(jax.random.PRNGKey(0), CFG)
    pts = jax.random.uniform(jax.random.PRNGKey(1), (8, 16, 3),
                             minval=-1, maxval=1)
    vd = jnp.zeros_like(pts).at[..., 2].set(1.0)
    sigma, rgb = apply_nerf(params, pts, vd, CFG, jnp.bfloat16)
    assert sigma.shape == (8, 16) and rgb.shape == (8, 16, 3)
    assert bool(jnp.isfinite(sigma).all()) and bool((sigma >= 0).all())
    assert bool((rgb >= 0).all() and (rgb <= 1).all())

    def loss(p):
        s, c = apply_nerf(p, pts, vd, CFG, None)
        return jnp.mean(s * s) + jnp.mean(c * c)

    g = jax.grad(loss)(params)
    for name in ("lines", "sigma1", "sigma2", "color1", "color2", "rgb"):
        leaf = g[name]["w"] if isinstance(g[name], dict) else g[name]
        assert float(jnp.abs(leaf).sum()) > 0, f"no grad into {name}"


@pytest.mark.slow
def test_factored_converges():
    """Time-to-quality at test scale: the factored field cuts its own
    starting loss by 4x within 100 steps on the sphere fit."""
    from tests.test_train import _run_training

    cfg = Config(
        camera=CameraConfig(width=32, height=32),
        model=ModelConfig(arch="factored", fac_levels=4, fac_base_res=4,
                          fac_max_res=32, fac_comps=16, fac_aabb=1.2,
                          sigma_activation="softplus"),
        render=RenderConfig(num_samples=32),
        train=TrainConfig(num_rays=256, learning_rate=1e-2,
                          precision="f32"),
    )
    state, losses = _run_training(cfg, steps=100)
    assert np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) * 0.25, (
        f"factored did not converge: {np.mean(losses[:10]):.4f} -> "
        f"{np.mean(losses[-10:]):.4f}"
    )


@pytest.mark.slow
def test_l1_regularizer_enters_loss_and_grads():
    """fac_l1 adds mean|lines| to the loss and a sign term to the line
    gradients (TensoRF grid sparsity)."""
    from nerf_rs_tpu.train.step import loss_fn

    def cfg_with(l1):
        import dataclasses
        return Config(
            camera=CameraConfig(width=32, height=32),
            model=dataclasses.replace(CFG, fac_l1=l1),
            render=RenderConfig(num_samples=16),
            train=TrainConfig(num_rays=64, precision="f32"),
        )

    key = jax.random.PRNGKey(0)
    state = init_state(key, cfg_with(0.0))
    o = jnp.zeros((64, 3)).at[:, 2].set(-1.0)
    d = jnp.zeros((64, 3)).at[:, 2].set(1.0)
    batch = Batch(origins=o, dirs=d, gold=jnp.ones((64, 3)) * 0.5)
    l0, _ = loss_fn(state.params, batch, key, cfg_with(0.0))
    l1, _ = loss_fn(state.params, batch, key, cfg_with(0.1))
    want = 0.1 * float(jnp.mean(jnp.abs(state.params["lines"])))
    np.testing.assert_allclose(float(l1 - l0), want, rtol=1e-4)

    g = jax.grad(lambda p: loss_fn(p, batch, key, cfg_with(0.1))[0])(
        state.params)
    g0 = jax.grad(lambda p: loss_fn(p, batch, key, cfg_with(0.0))[0])(
        state.params)
    n = state.params["lines"].size
    np.testing.assert_allclose(
        np.asarray(g["lines"] - g0["lines"]),
        np.asarray(0.1 * jnp.sign(state.params["lines"]) / n),
        atol=1e-7)


def test_checkpoint_roundtrip(tmp_path):
    from nerf_rs_tpu.train import checkpoint as ckpt

    cfg = Config(camera=CameraConfig(width=32, height=32), model=CFG,
                 render=RenderConfig(num_samples=16),
                 train=TrainConfig(num_rays=64, precision="f32"))
    state = init_state(jax.random.PRNGKey(0), cfg)
    path = ckpt.save(state, str(tmp_path))
    template = init_state(jax.random.PRNGKey(1), cfg)
    restored = ckpt.restore(path, template)
    for a, b in zip(jax.tree_util.tree_leaves(state.params),
                    jax.tree_util.tree_leaves(restored.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.slow
def test_factored_preset_cli_end_to_end(tmp_path):
    from nerf_rs_tpu.cli import main

    save_dir = str(tmp_path / "ckpt")
    common = [
        "--dataset", "sphere", "--width", "24", "--height", "24",
        "--num_rays", "128", "--num_samples", "16",
        "--num_views_per_hemisphere", "2",
        "--preset", "factored",
        "--fac_levels", "3", "--fac_base_res", "4", "--fac_max_res", "16",
        "--fac_comps", "8",
        "--fac_aabb", "1.2", "--precision", "f32",
        "--log_dir", str(tmp_path / "logs"), "--save_dir", save_dir,
    ]
    rc = main(["train", *common, "--num_iter", "12", "--save_steps", "10",
               "--eval_steps", "100", "--logging_steps", "100"])
    assert rc == 0
    assert any(c.startswith("checkpoint-") for c in os.listdir(save_dir))
    rc = main(["eval", *common, "--max_views", "1"])
    assert rc == 0
