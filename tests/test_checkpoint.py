"""Checkpoint round-trip: params + optimizer state + step survive
save/restore (the reference loses Adam moments and the step counter,
SURVEY §3.4 — we must not)."""

import os

import jax
import jax.numpy as jnp
import numpy as np

from nerf_rs_tpu.config import CameraConfig, Config, ModelConfig, RenderConfig, TrainConfig
from nerf_rs_tpu.data import synthetic
from nerf_rs_tpu.ops import rays
from nerf_rs_tpu.train import Batch, checkpoint as ckpt, init_state, train_step


def _cfg():
    return Config(
        camera=CameraConfig(width=16, height=16),
        model=ModelConfig(net_depth=2, net_width=16, skip_layer=9, feature_width=16, view_head_width=8, pos_enc_levels=2, dir_enc_levels=1),
        render=RenderConfig(num_samples=8),
        train=TrainConfig(num_rays=32, precision="f32"),
    )


def _batch(cfg, key):
    coords = jax.random.uniform(key, (32, 2)) * 15.0
    o, d = rays.rays_for_coords(coords, None, cfg.camera)
    img = synthetic.sphere_image(cfg.camera)
    gold = img[coords[:, 1].astype(jnp.int32), coords[:, 0].astype(jnp.int32), :3]
    return Batch(o, d, gold)


def test_roundtrip_preserves_everything(tmp_path):
    cfg = _cfg()
    key = jax.random.PRNGKey(0)
    state = init_state(key, cfg)
    for i in range(3):
        state, _ = train_step(state, _batch(cfg, jax.random.fold_in(key, i)), key, cfg)
    path = ckpt.save(state, str(tmp_path), ts=1234)
    assert os.path.basename(path) == "checkpoint-1234-3.npz"

    fresh = init_state(jax.random.PRNGKey(9), cfg)  # different seed
    restored = ckpt.restore(path, fresh)
    assert int(restored.step) == 3
    np.testing.assert_array_equal(
        np.asarray(restored.params["trunk"][0]["w"]),
        np.asarray(state.params["trunk"][0]["w"]),
    )
    # optimizer moments restored (leaf-wise equality over the whole tree)
    for a, b in zip(
        jax.tree_util.tree_leaves(restored.opt_state),
        jax.tree_util.tree_leaves(state.opt_state),
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_restore_weights_across_optimizer_configs(tmp_path):
    # a run trained with an lr SCHEDULE has an extra count leaf in its
    # opt_state; eval/render restore must not care (regression: the
    # 30k record run's checkpoint was unreadable by `cli eval` until
    # restore_weights decoupled inference from optimizer hparams)
    import dataclasses

    cfg = _cfg()
    cfg_sched = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, lr_decay_steps=100)
    )
    key = jax.random.PRNGKey(0)
    state = init_state(key, cfg_sched)
    for i in range(2):
        state, _ = train_step(
            state, _batch(cfg_sched, jax.random.fold_in(key, i)), key,
            cfg_sched,
        )
    path = ckpt.save(state, str(tmp_path), ts=99)

    fresh = init_state(jax.random.PRNGKey(9), cfg)  # constant-lr template
    restored = ckpt.restore_weights(path, fresh)
    assert int(restored.step) == 2
    np.testing.assert_array_equal(
        np.asarray(restored.params["trunk"][0]["w"]),
        np.asarray(state.params["trunk"][0]["w"]),
    )

    # training continues identically from restored vs original
    nb = _batch(cfg, jax.random.fold_in(key, 50))
    s1, a1 = train_step(state, nb, key, cfg)
    s2, a2 = train_step(restored, nb, key, cfg)
    np.testing.assert_allclose(float(a1["loss"]), float(a2["loss"]), rtol=1e-6)


def test_latest_checkpoint(tmp_path):
    cfg = _cfg()
    state = init_state(jax.random.PRNGKey(0), cfg)
    assert ckpt.latest_checkpoint(str(tmp_path)) is None
    ckpt.save(state, str(tmp_path), ts=100)
    state = state._replace(step=state.step + 5)
    p2 = ckpt.save(state, str(tmp_path), ts=200)
    assert ckpt.latest_checkpoint(str(tmp_path)) == p2
    assert ckpt.latest_checkpoint(str(tmp_path) + "/nope") is None


def test_restore_pre_grid_checkpoint(tmp_path):
    """A checkpoint that carries no ``grid`` (saved without --occ_res)
    restores into an occupancy-grid config: the grid starts from the
    template, every other field from the file (ADVICE r2)."""
    import dataclasses

    cfg = _cfg()
    state = init_state(jax.random.PRNGKey(0), cfg)
    assert state.grid is None
    path = ckpt.save(state, str(tmp_path), ts=1)
    cfg_occ = dataclasses.replace(
        cfg, render=RenderConfig(num_samples=8, occ_res=4))
    template = init_state(jax.random.PRNGKey(5), cfg_occ)
    restored = ckpt.restore(path, template)
    np.testing.assert_array_equal(np.asarray(restored.grid),
                                  np.asarray(template.grid))
    for a, b in zip(
        jax.tree_util.tree_leaves(restored.params),
        jax.tree_util.tree_leaves(state.params),
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))


def test_restore_weights_warns_on_dropped_grid(tmp_path):
    """An occ-trained checkpoint evaluated without --occ_res silently
    falls back to uniform sampling (measured -18 dB); the drop must be
    loud (ADVICE r2)."""
    import warnings

    import dataclasses

    cfg_occ = dataclasses.replace(
        _cfg(), render=RenderConfig(num_samples=8, occ_res=4)
    )
    state = init_state(jax.random.PRNGKey(0), cfg_occ)
    assert state.grid is not None
    path = ckpt.save(state, str(tmp_path))
    tmpl = init_state(jax.random.PRNGKey(0), _cfg())  # no occ_res
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ckpt.restore_weights(path, tmpl)
    assert any("grid" in str(x.message) for x in w), [str(x.message) for x in w]


def test_file_is_plain_npz_written_atomically(tmp_path):
    """Every leaf sits in the archive under "<field>/<key path>", loads
    without pickle, and the temporary file is gone after the write."""
    cfg = _cfg()
    state = init_state(jax.random.PRNGKey(0), cfg)
    path = ckpt.save(state, str(tmp_path), ts=7)
    assert os.listdir(tmp_path) == [os.path.basename(path)]
    with np.load(path, allow_pickle=False) as z:
        names = set(z.files)
        np.testing.assert_array_equal(
            z["params/['trunk'][0]['w']"],
            np.asarray(state.params["trunk"][0]["w"]))
    assert "step/" in names
    assert not any(n.startswith("fine_params/") for n in names)


def test_restore_rejects_another_configuration(tmp_path):
    import dataclasses

    import pytest

    cfg = _cfg()
    path = ckpt.save(init_state(jax.random.PRNGKey(0), cfg), str(tmp_path))
    wider = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, net_width=24))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(path, init_state(jax.random.PRNGKey(0), wider))
    deeper = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, net_depth=3))
    with pytest.raises(KeyError, match="different configuration"):
        ckpt.restore(path, init_state(jax.random.PRNGKey(0), deeper))


def test_error_store_sidecar_roundtrip(tmp_path):
    cfg = _cfg()
    state = init_state(jax.random.PRNGKey(0), cfg)
    err = np.linspace(0.0, 1.0, 12, dtype=np.float32).reshape(3, 4)
    path = ckpt.save(state, str(tmp_path), ts=3, err_store=jnp.asarray(err))
    np.testing.assert_array_equal(ckpt.load_err_store(path), err)
    bare = ckpt.save(state, str(tmp_path / "bare"), ts=3)
    assert ckpt.load_err_store(bare) is None
