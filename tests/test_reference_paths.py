"""The XLA training path of every sampler/encoding configuration against
the plain float32 reference, and loss_fn's gradients against finite
differences.

The shipped path runs the field in bf16 ("mixed"); the reference is the
same loss_fn in float32 under jax.default_matmul_precision("highest")
(chip_smoke.reference_gap, which the card runs at full width with the
same tolerances)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from nerf_rs_tpu.config import (
    CameraConfig, Config, DataConfig, ModelConfig, ProposalConfig,
    RenderConfig, TrainConfig,
)
from nerf_rs_tpu.data.device_dataset import DeviceDataset
from nerf_rs_tpu.data.factory import make_dataset
from nerf_rs_tpu.train import step as step_mod

TINY_MLP = dict(net_depth=4, net_width=32, skip_layer=2, feature_width=32,
                view_head_width=16, pos_enc_levels=4, dir_enc_levels=2)
CAM = CameraConfig(width=16, height=16)
CAM_360 = CameraConfig(width=16, height=16, near=0.3, far=60.0)


def _sphere_grid(res=8, aabb=1.6):
    """Occupancy grid of the sphere scene: dense inside radius 0.5."""
    c = (jnp.arange(res) + 0.5) / res * 2 * aabb - aabb
    x, y, z = jnp.meshgrid(c, c, c, indexing="ij")
    return jnp.where(x * x + y * y + z * z < 0.6 ** 2, 50.0, 0.0)


CASES = {
    "hierarchical": dict(
        render=RenderConfig(num_samples=8, num_fine_samples=16,
                            white_background=True)),
    "ipe_standalone": dict(
        model=dict(ipe=True, sigma_activation="softplus"),
        render=RenderConfig(num_samples=8, num_fine_samples=16,
                            share_network=True, fine_mode="standalone",
                            white_background=True)),
    # the record shape: S + S_f + 1 = 193 merged intervals
    "ipe_union_193": dict(
        model=dict(ipe=True, sigma_activation="softplus"),
        render=RenderConfig(num_samples=64, num_fine_samples=128,
                            share_network=True, fine_mode="union",
                            white_background=True),
        num_rays=16),
    "contraction": dict(
        camera=CAM_360, model=dict(contract=True, sigma_activation="softplus"),
        render=RenderConfig(num_samples=16, sampling_space="disparity")),
    # the two-level proposal resamples from its own bf16 histograms, so
    # the shipped and the reference pass see different sample positions
    # and the proposal MLP's gradients differ by more than rounding
    # (cosine ~0.8 at init): only the loss is compared, as on the card
    "disparity_distortion": dict(
        loss_only=True,
        camera=CAM_360, model=dict(contract=True, sigma_activation="softplus"),
        render=RenderConfig(num_samples=16, sampling_space="disparity"),
        distortion_weight=0.01,
        proposal=ProposalConfig(enabled=True, num_samples=16, num_levels=2,
                                net_width=16, anneal_steps=10)),
    "proposal": dict(
        render=RenderConfig(num_samples=16, white_background=True),
        proposal=ProposalConfig(enabled=True, num_samples=8, net_width=16)),
    # forward-facing capture: identity camera-to-world, NDC rays
    "ndc": dict(
        camera=CameraConfig(width=16, height=16, near=0.0, far=1.0, ndc=True,
                            focal=20.0),
        render=RenderConfig(num_samples=16), c2w=True),
    "occupancy_edges": dict(
        model=dict(ipe=True, sigma_activation="softplus"),
        render=RenderConfig(num_samples=16, num_fine_samples=16,
                            share_network=True, fine_mode="union",
                            occ_res=8, occ_aabb=1.6, occ_bins=16,
                            white_background=True),
        grid=True),
    "multiscale": dict(
        model=dict(ipe=True, sigma_activation="softplus"),
        render=RenderConfig(num_samples=16),
        data=DataConfig(dataset="sphere", multiscale_levels=2)),
}


def _config(c, precision="mixed"):
    return Config(
        camera=c.get("camera", CAM),
        model=ModelConfig(**TINY_MLP, **c.get("model", {})),
        render=c["render"],
        train=TrainConfig(num_rays=c.get("num_rays", 64), precision=precision,
                          distortion_weight=c.get("distortion_weight", 0.0)),
        proposal=c.get("proposal", ProposalConfig()),
        data=c.get("data", DataConfig(dataset="sphere")),
    )


def _inputs(cfg, c):
    if c.get("c2w"):
        imgs = np.full((1, 16, 16, 4), 128, np.uint8)
        ds = DeviceDataset(imgs, cfg.camera,
                           c2w=np.eye(4, dtype=np.float32)[None])
    else:
        ds = make_dataset(cfg)
    batch = ds.sample_batch(jax.random.PRNGKey(1), cfg.train.num_rays)
    state = step_mod.init_state(jax.random.PRNGKey(0), cfg)
    grid = _sphere_grid() if c.get("grid") else state.grid
    return step_mod._trainable(state, cfg), batch, grid, jnp.int32(5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_xla_path_matches_f32_reference(case):
    cfg = _config(CASES[case])
    trainable, batch, grid, step = _inputs(cfg, CASES[case])
    if case == "multiscale":
        assert batch.radii is not None  # the pyramid's per-ray cones
    gap = cs.reference_gap(cfg, trainable, batch, jax.random.PRNGKey(2),
                           grid, step, grads=not CASES[case].get("loss_only"))
    cs._check_gap(gap, case)


FD_CASES = {
    "nerf": dict(render=RenderConfig(num_samples=8)),
    "ipe": dict(model=dict(ipe=True, sigma_activation="softplus"),
                render=RenderConfig(num_samples=8)),
    "contract_distortion": dict(
        camera=CAM_360, model=dict(contract=True, sigma_activation="softplus"),
        render=RenderConfig(num_samples=8, sampling_space="disparity"),
        distortion_weight=0.1),
    "factored": dict(model=dict(arch="factored", sigma_activation="softplus",
                                fac_levels=3, fac_max_res=64, fac_comps=8,
                                hash_mlp_width=16),
                     render=RenderConfig(num_samples=8)),
    "hashgrid": dict(model=dict(arch="hashgrid", sigma_activation="softplus",
                                hash_levels=4, hash_table_log2=10,
                                hash_max_res=64, hash_mlp_width=16),
                     render=RenderConfig(num_samples=8)),
}


@pytest.mark.parametrize("case", sorted(FD_CASES))
def test_loss_grad_matches_finite_differences(case):
    """Central differences of loss_fn along the gradient's own direction
    equal the gradient's norm. Only configurations whose sample
    positions do not depend on the weights: a resampling pass moves its
    samples under a finite step but holds them fixed (stop-gradient)
    under autodiff."""
    cfg = _config(FD_CASES[case], precision="f32")
    trainable, batch, grid, _ = _inputs(cfg, FD_CASES[case])
    key = jax.random.PRNGKey(3)

    def loss(t):
        return step_mod.loss_fn(t, batch, key, cfg, grid)[0]

    with jax.default_matmul_precision("highest"):
        g = jax.grad(loss)(trainable)
        leaves, tree = jax.tree_util.tree_flatten(g)
        norm = float(np.sqrt(sum(float(jnp.sum(x * x)) for x in leaves)))
        assert norm > 0
        v = jax.tree_util.tree_unflatten(tree, [x / norm for x in leaves])
        eps = 1e-3

        def moved(s):
            return jax.tree_util.tree_map(lambda p, d: p + s * d,
                                          trainable, v)

        fd = (float(loss(moved(eps))) - float(loss(moved(-eps)))) / (2 * eps)
    np.testing.assert_allclose(fd, norm, rtol=2e-2)
