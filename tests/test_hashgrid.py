"""Instant-NGP hash-grid architecture (models/hashgrid.py): encoding
properties, gradient flow, trainer integration, checkpoint round-trip,
and CLI/preset wiring. The reference has one fixed MLP
(src/model.rs:45-93); this is the framework's second model family.
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
from nerf_rs_tpu.models import hashgrid
from nerf_rs_tpu.models.mlp import apply_nerf, init_nerf_params
from nerf_rs_tpu.train import Batch, init_state, train_step

CFG = ModelConfig(
    arch="hashgrid", hash_levels=4, hash_table_log2=10, hash_base_res=4,
    hash_max_res=32, hash_aabb=1.0, sigma_activation="softplus",
)


def test_level_resolutions_geometric():
    rs = hashgrid.level_resolutions(CFG)
    assert rs[0] == 4 and rs[-1] == 32 and len(rs) == 4
    assert all(b > a for a, b in zip(rs, rs[1:]))


def test_encode_at_dense_vertex_hits_table_entry():
    """At an exact grid vertex of a DENSE level, trilinear weights
    collapse onto one corner, so the encoding equals that vertex's
    table row."""
    cfg = ModelConfig(arch="hashgrid", hash_levels=1, hash_table_log2=10,
                      hash_base_res=4, hash_max_res=4, hash_aabb=1.0)
    T = 1 << 10
    table = jnp.arange(T * 2, dtype=jnp.float32).reshape(T, 2)
    # vertex (1, 2, 3) of the 4-res grid: u = idx/4 -> x = 2*u - 1
    pt = jnp.asarray([[2 * 0.25 - 1, 2 * 0.5 - 1, 2 * 0.75 - 1]])
    enc = hashgrid.hash_encode(table, pt, cfg)
    want = table[1 + 5 * (2 + 5 * 3)]
    np.testing.assert_allclose(np.asarray(enc[0]), np.asarray(want),
                               rtol=1e-5)


def test_encode_continuity():
    """Encoding is continuous: nearby points give nearby features."""
    params = init_nerf_params(jax.random.PRNGKey(0), CFG)
    p = jax.random.uniform(jax.random.PRNGKey(1), (32, 3),
                           minval=-0.9, maxval=0.9)
    e1 = hashgrid.hash_encode(params["table"], p, CFG)
    e2 = hashgrid.hash_encode(params["table"], p + 1e-5, CFG)
    assert float(jnp.abs(e1 - e2).max()) < 1e-3


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
    for name in ("table", "sigma1", "sigma2", "color1", "color2", "rgb"):
        leaf = g[name]["w"] if isinstance(g[name], dict) else g[name]
        assert float(jnp.abs(leaf).sum()) > 0, f"no grad into {name}"


@pytest.mark.slow
def test_hashgrid_converges_faster_than_tiny_mlp():
    """The time-to-quality claim at test scale: on the sphere fit the
    hash-grid reaches a lower loss than its own start within 100 steps
    (and historically beats the 4x64 MLP's trajectory)."""
    from tests.test_train import _run_training

    cfg = Config(
        camera=CameraConfig(width=32, height=32),
        model=ModelConfig(arch="hashgrid", hash_levels=8,
                          hash_table_log2=12, hash_base_res=4,
                          hash_max_res=64, hash_aabb=1.2,
                          sigma_activation="softplus"),
        render=RenderConfig(num_samples=32),
        train=TrainConfig(num_rays=256, learning_rate=1e-2,
                          precision="f32"),
    )
    state, losses = _run_training(cfg, steps=100)
    assert np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) * 0.25, (
        f"hashgrid did not converge: {np.mean(losses[:10]):.4f} -> "
        f"{np.mean(losses[-10:]):.4f}"
    )


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
def test_ngp_preset_cli_end_to_end(tmp_path):
    from nerf_rs_tpu.cli import main

    save_dir = str(tmp_path / "ckpt")
    common = [
        "--dataset", "sphere", "--width", "24", "--height", "24",
        "--num_rays", "128", "--num_samples", "16",
        "--num_views_per_hemisphere", "2",
        "--preset", "ngp",
        "--hash_levels", "4", "--hash_table_log2", "10",
        "--hash_base_res", "4", "--hash_max_res", "32",
        "--hash_aabb", "1.2", "--precision", "f32",
        "--log_dir", str(tmp_path / "logs"), "--save_dir", save_dir,
    ]
    rc = main(["train", *common, "--num_iter", "12", "--save_steps", "10",
               "--eval_steps", "100", "--logging_steps", "100"])
    assert rc == 0
    assert any(c.startswith("checkpoint-") for c in os.listdir(save_dir))
    rc = main(["eval", *common, "--max_views", "1"])
    assert rc == 0


# ---- brick layout (round 4: models/hashgrid.brick_encode) ------------------

BRICK_CFG = ModelConfig(
    arch="hashgrid", hash_levels=4, hash_table_log2=10, hash_base_res=4,
    hash_max_res=32, hash_aabb=1.0, sigma_activation="softplus",
    hash_brick=True,
)


def test_brick_param_budget_matches_flat():
    """Same parameter count as the flat layout: T_b rows of 128 = T
    entries of F."""
    pb = init_nerf_params(jax.random.PRNGKey(0), BRICK_CFG)
    pf = init_nerf_params(jax.random.PRNGKey(0),
                          ModelConfig(**{**BRICK_CFG.__dict__,
                                         "hash_brick": False}))
    assert pb["table"].size == pf["table"].size
    assert pb["table"].shape[-1] == 128


def test_brick_encode_at_dense_vertex_hits_brick_lane():
    """At an exact vertex of a dense level the encoding equals the
    stored lane of the enclosing brick (offset = v - 3*(v//3))."""
    cfg = ModelConfig(arch="hashgrid", hash_levels=1, hash_table_log2=13,
                      hash_base_res=4, hash_max_res=4, hash_aabb=1.0,
                      hash_brick=True)
    Tb = hashgrid.brick_table_entries(cfg)
    assert Tb == 128 and (2 ** 3) <= Tb  # res-4 brick grid (2^3) is dense
    table = jnp.arange(Tb * 128, dtype=jnp.float32).reshape(Tb, 128)
    # vertex (1, 2, 3) of the res-4 grid: u = v/4 -> x = 2u - 1
    pt = jnp.asarray([[2 * 0.25 - 1, 2 * 0.5 - 1, 2 * 0.75 - 1]])
    enc = hashgrid.brick_encode(table, pt, cfg)
    # brick (0,0,1) -> flat 0 + 2*(0 + 2*1) = 4; offset (1,2,0) ->
    # lane ((1*4+2)*4+0)*2 = 48
    want = table[4, 48:50]
    np.testing.assert_allclose(np.asarray(enc[0]), np.asarray(want),
                               rtol=1e-5)


def test_brick_encode_trilinear_cell_center():
    """At a cell center the encoding is the mean of the 8 corner lanes
    of the single enclosing brick."""
    cfg = ModelConfig(arch="hashgrid", hash_levels=1, hash_table_log2=13,
                      hash_base_res=4, hash_max_res=4, hash_aabb=1.0,
                      hash_brick=True)
    Tb = hashgrid.brick_table_entries(cfg)
    table = jnp.asarray(
        np.random.RandomState(0).randn(Tb, 128).astype(np.float32))
    # center of cell (0,0,0): u = 0.125 -> scaled 0.5, all in brick 0
    pt = jnp.asarray([[2 * 0.125 - 1] * 3])
    enc = hashgrid.brick_encode(table, pt, cfg)
    lanes = [(((dx * 4 + dy) * 4 + dz)) * 2
             for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
    want = np.stack([np.asarray(table[0, ln:ln + 2]) for ln in lanes]
                    ).mean(0)
    np.testing.assert_allclose(np.asarray(enc[0]), want, rtol=1e-5)


def test_brick_encode_in_range_and_grad_flow():
    params = init_nerf_params(jax.random.PRNGKey(0), BRICK_CFG)
    pts = jax.random.uniform(jax.random.PRNGKey(1), (8, 16, 3),
                             minval=-1.2, maxval=1.2)  # incl. out-of-box
    vd = jnp.zeros_like(pts).at[..., 2].set(1.0)
    sigma, rgb = apply_nerf(params, pts, vd, BRICK_CFG, jnp.bfloat16)
    assert sigma.shape == (8, 16) and rgb.shape == (8, 16, 3)
    assert bool(jnp.isfinite(sigma).all())

    def loss(p):
        s, c = apply_nerf(p, pts, vd, BRICK_CFG, None)
        return jnp.mean(s * s) + jnp.mean(c * c)

    g = jax.grad(loss)(params)
    assert float(jnp.abs(g["table"]).sum()) > 0


def test_brick_train_step_runs():
    cfg = Config(camera=CameraConfig(width=32, height=32),
                 model=BRICK_CFG, render=RenderConfig(num_samples=16),
                 train=TrainConfig(num_rays=64, precision="f32"))
    state = init_state(jax.random.PRNGKey(0), cfg)
    o = jnp.zeros((64, 3)).at[:, 2].set(-1.0)
    d = jnp.zeros((64, 3)).at[:, 2].set(1.0)
    batch = Batch(origins=o, dirs=d, gold=jnp.ones((64, 3)) * 0.5)
    state, aux = train_step(state, batch, jax.random.PRNGKey(1), cfg)
    assert np.isfinite(float(aux["loss"]))


def test_brick_requires_f2():
    cfg = ModelConfig(arch="hashgrid", hash_features=4, hash_brick=True,
                      hash_levels=2, hash_table_log2=10)
    with pytest.raises(ValueError, match="hash_features=2"):
        hashgrid.brick_encode(jnp.zeros((32, 128)), jnp.zeros((4, 3)),
                              cfg)


def test_brick_encode_chunked_matches_direct(monkeypatch):
    """The big-batch lax.map chunking path returns exactly the direct
    result (padding sliced off, order preserved)."""
    cfg = ModelConfig(arch="hashgrid", hash_levels=2, hash_table_log2=13,
                      hash_base_res=4, hash_max_res=16, hash_aabb=1.0,
                      hash_brick=True)
    Tb = hashgrid.brick_table_entries(cfg)
    table = jnp.asarray(
        np.random.RandomState(1).randn(2 * Tb, 128).astype(np.float32))
    pts = jax.random.uniform(jax.random.PRNGKey(2), (70, 3),
                             minval=-1, maxval=1)
    direct = hashgrid.brick_encode(table, pts, cfg)
    monkeypatch.setattr(hashgrid, "_BRICK_CHUNK", 32)  # force 3 chunks
    chunked = hashgrid.brick_encode(table, pts, cfg)
    np.testing.assert_allclose(np.asarray(chunked), np.asarray(direct),
                               rtol=1e-6)
