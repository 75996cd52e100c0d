"""Proposal-network sampling (ops/proposal.py, models/proposal.py) —
a capability beyond the reference (its only sampling is uniform-random
t, src/ray_sampling.rs:96-142); mip-NeRF 360 lineage."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nerf_rs_tpu.config import (
    CameraConfig, Config, ModelConfig, ProposalConfig, RenderConfig,
    TrainConfig,
)
from nerf_rs_tpu.models.proposal import apply_proposal, init_proposal_params
from nerf_rs_tpu.ops import proposal as prop_ops
from nerf_rs_tpu.train.step import (
    Batch, eval_step, init_state, loss_fn, train_step, _trainable,
)

KEY = jax.random.PRNGKey(0)


def _cfg(num_levels=1, **kw):
    small_model = ModelConfig(
        net_depth=2, net_width=32, skip_layer=1, feature_width=32,
        view_head_width=16, pos_enc_levels=4, dir_enc_levels=2,
    )
    return Config(
        camera=CameraConfig(width=16, height=16),
        model=kw.pop("model", small_model),
        render=RenderConfig(num_samples=16),
        proposal=ProposalConfig(
            enabled=True, num_samples=16, num_levels=num_levels,
            net_depth=2, net_width=16, pos_enc_levels=4,
        ),
        train=TrainConfig(num_rays=64, precision="f32", learning_rate=2e-3),
        **kw,
    )


def _batch(n=64):
    ko, kd, kg = jax.random.split(jax.random.PRNGKey(1), 3)
    o = (jax.random.normal(ko, (n, 3)) * 0.1).at[:, 2].add(-1.0)
    d = (jax.random.normal(kd, (n, 3)) * 0.05).at[:, 2].add(1.0)
    return Batch(origins=o, dirs=d, gold=jax.random.uniform(kg, (n, 3)))


def test_edges_from_ts():
    ts = jnp.asarray([[0.1, 0.4, 0.9]])
    e = prop_ops.edges_from_ts(ts)
    np.testing.assert_allclose(e, [[0.1, 0.25, 0.65, 0.9]], atol=1e-6)


def test_interlevel_loss_zero_when_covered():
    # proposal histogram identical to the main one -> bound holds -> 0
    edges = jnp.linspace(0.0, 1.0, 9)[None].repeat(4, 0)
    w = jax.random.uniform(KEY, (4, 8)) * 0.1
    loss = prop_ops.interlevel_loss(edges, w, edges, w)
    assert float(loss) < 1e-9
    # wider proposal bins that still cover -> 0 (overlap sums over-count)
    coarse_edges = jnp.linspace(0.0, 1.0, 5)[None].repeat(4, 0)
    w_c = jnp.full((4, 4), 0.2)
    assert float(prop_ops.interlevel_loss(edges, w, coarse_edges, w_c)) < 1e-9


def test_interlevel_loss_positive_when_missed():
    edges = jnp.linspace(0.0, 1.0, 9)[None]
    w_main = jnp.zeros((1, 8)).at[0, 3].set(0.9)  # mass in bin 3
    w_prop = jnp.zeros((1, 8)).at[0, 7].set(0.9)  # proposal looks at bin 7
    loss = prop_ops.interlevel_loss(edges, w_main, edges, w_prop)
    assert float(loss) > 0.1
    # and the gradient pushes the proposal's bin-3 weight UP
    g = jax.grad(
        lambda wp: prop_ops.interlevel_loss(edges, w_main, edges, wp)
    )(w_prop)
    assert float(g[0, 3]) < 0.0  # increase w_prop[3] to reduce loss
    # stop-grad on the main histogram: no grad flows to it
    gm = jax.grad(
        lambda wm: prop_ops.interlevel_loss(edges, wm, edges, w_prop)
    )(w_main)
    assert float(jnp.abs(gm).max()) == 0.0


def test_proposal_resample_sorted_in_range():
    pcfg = ProposalConfig(num_samples=16, net_depth=2, net_width=16,
                          pos_enc_levels=4)
    pp = init_proposal_params(KEY, pcfg)
    b = _batch(32)
    cam = CameraConfig(width=16, height=16)
    ts, hists = prop_ops.proposal_resample(
        KEY, b.origins, b.dirs, pp, pcfg, 24, cam, True
    )
    assert ts.shape == (32, 24)
    assert bool(jnp.all(jnp.diff(ts, axis=-1) >= 0))
    assert bool(jnp.all((ts >= cam.near) & (ts <= cam.far)))
    assert len(hists) == 1
    (bins, w), = hists
    assert bins.shape == (32, 17) and w.shape == (32, 16)


def test_proposal_resample_two_levels():
    """num_levels=2 (mip-NeRF 360's count): two histograms, both
    differentiable to the shared params; final ts valid + sorted."""
    pcfg = ProposalConfig(num_samples=16, num_levels=2, net_depth=2,
                          net_width=16, pos_enc_levels=4)
    pp = init_proposal_params(KEY, pcfg)
    b = _batch(32)
    cam = CameraConfig(width=16, height=16)
    ts, hists = prop_ops.proposal_resample(
        KEY, b.origins, b.dirs, pp, pcfg, 24, cam, True
    )
    assert ts.shape == (32, 24)
    assert bool(jnp.all(jnp.diff(ts, axis=-1) >= 0))
    assert bool(jnp.all((ts >= cam.near) & (ts <= cam.far)))
    assert len(hists) == 2
    for bins, w in hists:
        assert bins.shape == (32, 17) and w.shape == (32, 16)
        assert bool(jnp.all(jnp.diff(bins, axis=-1) >= 0))

    # grads reach the shared proposal MLP through BOTH levels' weights
    def lvl_weight_sum(p, lvl):
        _, hs = prop_ops.proposal_resample(
            KEY, b.origins, b.dirs, p, pcfg, 24, cam, False
        )
        return jnp.sum(hs[lvl][1])

    for lvl in range(2):
        g = jax.grad(lvl_weight_sum)(pp, lvl)
        gmax = max(float(jnp.abs(x).max())
                   for x in jax.tree_util.tree_leaves(g))
        assert gmax > 0.0, lvl


def test_init_state_builds_proposal_net():
    cfg = _cfg()
    state = init_state(KEY, cfg)
    assert set(state.fine_params.keys()) == {"trunk", "sigma"}
    assert len(state.fine_params["trunk"]) == 2
    tr = _trainable(state, cfg)
    assert isinstance(tr, tuple) and len(tr) == 2


def test_proposal_rejects_hierarchical():
    cfg = _cfg()
    cfg = cfg.replace(render=RenderConfig(num_samples=16, num_fine_samples=8))
    with pytest.raises(AssertionError):
        init_state(KEY, cfg)


@pytest.mark.parametrize("num_levels", [1, 2])
def test_proposal_training_reduces_photometric_loss(num_levels):
    cfg = _cfg(num_levels=num_levels)
    state = init_state(KEY, cfg)
    b = _batch()
    first = None
    for i in range(40):
        state, aux = train_step(state, b, jax.random.fold_in(KEY, i), cfg)
        if first is None:
            first = jax.device_get(aux)
    last = jax.device_get(aux)
    assert np.isfinite(last["loss"])
    assert last["loss_coarse"] < first["loss_coarse"]
    assert np.isfinite(last["loss_prop"])
    # eval + render path: proposal guides, output finite
    out = eval_step(state, b, KEY, cfg)
    assert np.isfinite(float(out["psnr"]))
    assert out["rgb"].shape == (64, 3)


def test_interlevel_signal_trains_proposal_toward_fixed_main():
    # freeze the main network (the proposal's target is then stationary
    # — during joint training it legitimately chases a moving
    # histogram) and check SGD on the interlevel term alone drives the
    # proposal's loss down
    cfg = _cfg()
    state = init_state(KEY, cfg)
    b = _batch()
    params, prop = _trainable(state, cfg)

    def prop_only_loss(pp, k):
        loss, aux = loss_fn((params, pp), b, k, cfg)
        return aux["loss_prop"]

    # fixed key: the uniform ts_p draw is frozen; the resampled ts_m
    # still shifts as the proposal sharpens, so the target is only
    # quasi-stationary — assert a clear decrease, not a collapse
    k = jax.random.fold_in(KEY, 123)
    l0 = float(prop_only_loss(prop, k))
    g_fn = jax.jit(jax.grad(prop_only_loss))
    for _ in range(100):
        g = g_fn(prop, k)
        prop = jax.tree_util.tree_map(lambda p, gg: p - 0.02 * gg, prop, g)
    l1 = float(prop_only_loss(prop, k))
    assert l1 < 0.9 * l0, (l0, l1)


def test_proposal_annealing_ramps_to_identity():
    """anneal_steps > 0: early steps draw near-uniformly (exponent -> 0),
    late steps reproduce the unannealed distribution (exponent -> 1)."""
    import dataclasses
    import jax.numpy as jnp
    from nerf_rs_tpu.config import Config, ProposalConfig
    from nerf_rs_tpu.train.step import _prop_anneal

    cfg = Config(proposal=ProposalConfig(enabled=True, anneal_steps=1000))
    a0 = _prop_anneal(cfg, jnp.asarray(0, jnp.int32))
    a_mid = _prop_anneal(cfg, jnp.asarray(100, jnp.int32))
    a1 = _prop_anneal(cfg, jnp.asarray(1000, jnp.int32))
    a2 = _prop_anneal(cfg, jnp.asarray(5000, jnp.int32))
    assert float(a0) == 0.0
    assert 0.0 < float(a_mid) < 1.0
    assert float(a1) == 1.0 and float(a2) == 1.0
    off = Config(proposal=ProposalConfig(enabled=True, anneal_steps=0))
    assert _prop_anneal(off, jnp.asarray(10, jnp.int32)) is None
