"""Jitted training step: value_and_grad over the renderer + optax Adam.

Replacement for the reference's Trainer (src/model.rs:301-346):
MSE loss (mse_loss, src/model.rs:296-299), Adam at lr 5e-4
(src/model.rs:306-309), one fused XLA program per step. Gradient
accumulation — dead code in the reference (grad_accumulation_step,
src/model.rs:327-336) — is a real option here, folded into the same
jitted step via lax.scan over micro-batches. Data-parallel gradient
psum lives in parallel/dp.py; this module is the single-device core it
wraps.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from ..config import Config
from ..models.mlp import Params, init_nerf_params
from ..ops import render


class TrainState(NamedTuple):
    step: jnp.ndarray  # int32 scalar
    params: Params
    # the second trainable network: the separate fine MLP (hierarchical
    # paper scheme), or the tiny proposal MLP when cfg.proposal.enabled
    # (models/proposal.py) — the two are mutually exclusive by config.
    fine_params: Optional[Params]
    opt_state: Any
    # occupancy grid (ops/occupancy.py) when cfg.render.occ_res > 0:
    # (res, res, res) f32 EMA'd densities, updated OUTSIDE the train
    # step every occ_update_steps and checkpointed with the state.
    grid: Optional[jnp.ndarray] = None
    # exponential moving average of the TRAINABLE pytree (params, or
    # (params, fine_params) when a second net exists) when
    # cfg.train.ema_decay > 0; eval/render swap it in via
    # with_ema_params. None when EMA is off.
    ema: Optional[Any] = None


class Batch(NamedTuple):
    """One training batch of rays (device-ready, produced by data/)."""

    origins: jnp.ndarray  # (N, 3)
    dirs: jnp.ndarray  # (N, 3)
    gold: jnp.ndarray  # (N, 3) or (N, 4) target pixels
    # flat pixel index view*H*W + y*W + x of each ray, for the
    # highest-error resampling buffer (BASELINE config 5); None when
    # error resampling is off.
    idx: Optional[jnp.ndarray] = None
    # per-ray cone base radius at unit distance (multiscale training,
    # DataConfig.multiscale_levels): consumed by the --ipe interval path,
    # ignored by point-sampled models. None = single-scale (the camera's
    # pixel_radius).
    radii: Optional[jnp.ndarray] = None


def make_optimizer(cfg: Config) -> optax.GradientTransformation:
    t = cfg.train
    if t.lr_decay_steps > 0:
        sched = optax.exponential_decay(
            t.learning_rate,
            t.lr_decay_steps,
            t.lr_final / t.learning_rate,
        )
    else:
        sched = t.learning_rate  # constant, like the reference
    return optax.adam(sched)


def _has_fine_net(cfg: Config) -> bool:
    """Separate fine MLP (paper scheme); share_network reuses the
    coarse MLP for both hierarchical passes (fast fine pass in
    ops/render.render_rays)."""
    return cfg.render.num_fine_samples > 0 and not cfg.render.share_network


def _has_prop(cfg: Config) -> bool:
    return cfg.proposal.enabled


def _two_nets(cfg: Config) -> bool:
    """TrainState.fine_params is populated (fine MLP or proposal MLP)."""
    return _has_fine_net(cfg) or _has_prop(cfg)


def init_state(key: jax.Array, cfg: Config) -> TrainState:
    kc, kf = jax.random.split(key)
    params = init_nerf_params(kc, cfg.model)
    if _has_prop(cfg):
        assert cfg.render.num_fine_samples == 0, (
            "proposal sampling IS the hierarchy; set num_fine_samples=0"
        )
        assert not cfg.model.compat, "proposal needs the paper model"
        from ..models.proposal import init_proposal_params

        fine_params = init_proposal_params(kf, cfg.proposal)
    else:
        fine_params = (
            init_nerf_params(kf, cfg.model) if _has_fine_net(cfg) else None
        )
    opt = make_optimizer(cfg)
    trainable = (params, fine_params) if fine_params is not None else params
    opt_state = opt.init(trainable)
    grid = None
    if cfg.render.occ_res > 0:
        from ..ops import occupancy

        grid = occupancy.init_grid(cfg.render.occ_res)
    ema = None
    if cfg.train.ema_decay > 0.0:
        # initialized to the weights themselves (no cold-start debias
        # needed; matches common practice when EMA starts at init)
        ema = jax.tree_util.tree_map(jnp.array, trainable)
    return TrainState(
        jnp.zeros((), jnp.int32), params, fine_params, opt_state, grid, ema
    )


def _matmul_dtype(cfg: Config):
    p = cfg.train.precision
    if p in ("bf16", "mixed"):
        return jnp.bfloat16
    return None


def _prop_anneal(cfg: Config, step):
    """mip-NeRF 360 annealing exponent for the proposal resampling
    weights: bias(train_frac, slope) ramps 0 -> 1 over
    proposal.anneal_steps, so early training samples near-uniformly
    (the proposal histogram is garbage then) and sharpens as the
    proposal learns. 1.0 when off (anneal_steps == 0) or no step."""
    a = cfg.proposal.anneal_steps
    if a <= 0 or step is None:
        return None
    x = jnp.clip(step.astype(jnp.float32) / a, 0.0, 1.0)
    s = cfg.proposal.anneal_slope
    return s * x / ((s - 1.0) * x + 1.0)


def _reg_loss(params, cfg: Config) -> jnp.ndarray:
    """Architecture-specific parameter regularizers folded into the
    photometric loss. Factored family: TensoRF-style L1 on the line
    tables (cfg.model.fac_l1) — suppresses the CP axis-streak fog that
    costs SSIM on white-background scenes."""
    if cfg.model.arch == "factored" and cfg.model.fac_l1 > 0.0:
        return cfg.model.fac_l1 * jnp.mean(jnp.abs(params["lines"]))
    return jnp.float32(0.0)


def loss_fn(
    trainable,
    batch: Batch,
    key: jax.Array,
    cfg: Config,
    grid: Optional[jnp.ndarray] = None,
    step=None,
) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """MSE of composited colors vs gold pixels; with hierarchical
    sampling, coarse and fine losses are summed (paper eq. 6); with
    proposal sampling, photometric + interlevel (_proposal_loss)."""
    if _has_prop(cfg):
        params, prop_params = trainable
        return _proposal_loss(params, prop_params, batch, key, cfg,
                              step=step)
    if _has_fine_net(cfg):
        params, fine_params = trainable
    else:
        params, fine_params = trainable, None
    coarse, fine = render.render_rays(
        params,
        batch.origins,
        batch.dirs,
        key,
        cfg.model,
        cfg.render,
        cfg.camera,
        fine_params=fine_params,
        dtype=_matmul_dtype(cfg),
        grid=grid,
        radii=batch.radii,
    )
    gold_rgb = batch.gold[..., :3]
    loss_c = render.mse(coarse.rgb[..., :3], gold_rgb)
    loss = loss_c + _reg_loss(params, cfg)
    aux = {"loss_coarse": loss_c}
    if fine is not None:
        loss_f = render.mse(fine.rgb[..., :3], gold_rgb)
        loss = loss + loss_f
        aux["loss_fine"] = loss_f
        aux["psnr"] = render.psnr_from_mse(loss_f)
        finest = fine
    else:
        aux["psnr"] = render.psnr_from_mse(loss_c)
        finest = coarse
    if cfg.train.distortion_weight > 0.0:
        loss_d = render.distortion_loss(
            finest.weights, finest.ts, cfg.camera.near, cfg.camera.far,
            space=cfg.render.sampling_space,
            deltas=finest.deltas,  # IPE: exact interval lengths
        )
        loss = loss + cfg.train.distortion_weight * loss_d
        aux["loss_dist"] = loss_d
    aux["loss"] = loss
    # per-ray error (stop-grad): drives highest-error resampling
    aux["ray_err"] = jax.lax.stop_gradient(
        jnp.mean((finest.rgb[..., :3] - gold_rgb) ** 2, axis=-1)
    )
    return loss, aux


def _proposal_loss(
    params: Params,
    prop_params: Params,
    batch: Batch,
    key: jax.Array,
    cfg: Config,
    step=None,
) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Photometric loss on proposal-guided samples + interlevel bound
    loss training the proposal (ops/proposal.py; mip-NeRF 360 scheme)."""
    from ..models.mlp import apply_nerf
    from ..ops import proposal as prop_ops, sampling

    dtype = _matmul_dtype(cfg)
    kn = jax.random.fold_in(key, 11)
    ts_m, hists = prop_ops.proposal_resample(
        key, batch.origins, batch.dirs, prop_params, cfg.proposal,
        cfg.render.num_samples, cfg.camera, cfg.render.randomized, dtype,
        anneal=_prop_anneal(cfg, step), space=cfg.render.sampling_space,
        contract=cfg.model.contract,
    )
    gold_rgb = batch.gold[..., :3]
    pts = sampling.points_from_ts(batch.origins, batch.dirs, ts_m)
    vd = batch.dirs / jnp.linalg.norm(batch.dirs, axis=-1, keepdims=True)
    noise_std = cfg.render.raw_noise_std if cfg.render.randomized else 0.0
    sigma, rgb = apply_nerf(
        params, pts, vd[..., None, :], cfg.model, dtype,
        noise_std=noise_std, noise_key=kn,
    )
    out = render.composite(
        sigma, rgb[..., :3], sampling.deltas_from_ts(ts_m, cfg.camera.far),
        white_background=cfg.render.white_background, ts=ts_m,
    )
    rgb_m, w_m = out.rgb, out.weights
    loss_photo = render.mse(rgb_m[..., :3], gold_rgb)
    loss_il = prop_ops.multi_interlevel_loss(
        prop_ops.edges_from_ts(ts_m), w_m, hists
    )
    loss = (loss_photo + cfg.proposal.loss_mult * loss_il
            + _reg_loss(params, cfg))
    aux = {
        "loss": loss,
        "loss_coarse": loss_photo,
        "loss_prop": loss_il,
        "psnr": render.psnr_from_mse(loss_photo),
        "ray_err": jax.lax.stop_gradient(
            jnp.mean((rgb_m[..., :3] - gold_rgb) ** 2, axis=-1)
        ),
    }
    if cfg.train.distortion_weight > 0.0:
        loss_d = render.distortion_loss(
            w_m, ts_m, cfg.camera.near, cfg.camera.far,
            space=cfg.render.sampling_space,
        )
        loss = loss + cfg.train.distortion_weight * loss_d
        aux["loss_dist"] = loss_d
        aux["loss"] = loss
    return loss, aux


def _trainable(state: TrainState, cfg: Config):
    if _two_nets(cfg):
        return (state.params, state.fine_params)
    return state.params


def with_ema_params(state: TrainState) -> TrainState:
    """State with the EMA weights swapped in for params/fine_params —
    what eval/render should see when training ran with
    --ema_decay > 0. Identity when no EMA is carried. The structure of
    state.ema encodes whether a second net was trained (tuple) or not."""
    if state.ema is None:
        return state
    if isinstance(state.ema, tuple):
        return state._replace(params=state.ema[0], fine_params=state.ema[1])
    return state._replace(params=state.ema)


def _untrainable(trainable, cfg: Config):
    if _two_nets(cfg):
        return trainable
    return (trainable, None)


def apply_grads(
    state: TrainState, trainable, grads, opt, cfg: Config
) -> TrainState:
    """Shared optimizer tail: Adam update, params split, EMA update,
    step increment. EVERY step body (single-device, DP, error-resample,
    multi-scene) must go through this — a hand-rolled tail silently
    skips the EMA update (the bug the first --ema_decay drive hit: eval
    rendered the init weights forever)."""
    updates, opt_state = opt.update(grads, state.opt_state, trainable)
    trainable = optax.apply_updates(trainable, updates)
    params, fine_params = _untrainable(trainable, cfg)
    ema = state.ema
    if cfg.train.ema_decay > 0.0 and ema is not None:
        # DEBIASED EMA, stored bias-corrected: a raw EMA initialized at
        # the init weights still carries d^t of them (22% after 300
        # steps at d=0.995 — measured rendering garbage on the sphere
        # drive). Store deb_t = raw_t / (1 - d^t) with raw_0 = 0, so
        # the stored value is always an average of SEEN weights only
        # and eval can swap it in directly at any step.
        d = jnp.float32(cfg.train.ema_decay)
        t_prev = state.step.astype(jnp.float32)
        prev_scale = 1.0 - d ** t_prev  # 0 at the first step
        new_scale = 1.0 - d ** (t_prev + 1.0)
        ema = jax.tree_util.tree_map(
            lambda e, p: (d * prev_scale * e + (1.0 - d) * p) / new_scale,
            ema, trainable,
        )
    return state._replace(
        step=state.step + 1, params=params, fine_params=fine_params,
        opt_state=opt_state, ema=ema,
    )


@partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0,))
def train_step(
    state: TrainState, batch: Batch, key: jax.Array, cfg: Config
) -> Tuple[TrainState, Dict[str, jnp.ndarray]]:
    """One optimizer step (reference Trainer::step, src/model.rs:311-325),
    fully on-device. With cfg.train.accumulation_steps > 1, the batch's
    leading axis is split into micro-batches whose grads are averaged by
    a lax.scan before the single Adam update."""
    return train_step_core(state, batch, key, cfg)


def train_step_core(
    state: TrainState, batch: Batch, key: jax.Array, cfg: Config
) -> Tuple[TrainState, Dict[str, jnp.ndarray]]:
    """Unjitted step body — reused by the DP (parallel/dp.py) and
    multi-scene (parallel/multiscene.py) wrappers, which add their own
    collectives/vmap before jitting."""
    opt = make_optimizer(cfg)
    trainable = _trainable(state, cfg)
    acc = cfg.train.accumulation_steps

    if acc <= 1:
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            trainable, batch, key, cfg, state.grid, state.step
        )
    else:
        n = batch.origins.shape[0]
        micro = n // acc
        mb = jax.tree_util.tree_map(
            lambda x: x[: micro * acc].reshape(acc, micro, *x.shape[1:]), batch
        )
        keys = jax.random.split(key, acc)

        def body(carry, xs):
            g_sum, l_sum = carry
            b, k = xs
            (l, aux_i), g = jax.value_and_grad(loss_fn, has_aux=True)(
                trainable, b, k, cfg, state.grid
            )
            g_sum = jax.tree_util.tree_map(jnp.add, g_sum, g)
            return (g_sum, l_sum + l), aux_i

        zero = jax.tree_util.tree_map(jnp.zeros_like, trainable)
        (g_sum, l_sum), auxs = jax.tree_util.tree_map(
            lambda x: x, jax.lax.scan(body, (zero, 0.0), (mb, keys))
        )
        grads = jax.tree_util.tree_map(lambda g: g / acc, g_sum)
        loss = l_sum / acc
        ray_err = auxs.pop("ray_err").reshape(-1)  # (acc*micro,) per-ray
        aux = jax.tree_util.tree_map(lambda a: jnp.mean(a, axis=0), auxs)
        aux["ray_err"] = ray_err

    return apply_grads(state, trainable, grads, opt, cfg), aux


@partial(jax.jit, static_argnames=("cfg",))
def eval_step(
    state: TrainState, batch: Batch, key: jax.Array, cfg: Config
) -> Dict[str, jnp.ndarray]:
    """Deterministic (midpoint-sampled) evaluation pass."""
    prop = _has_prop(cfg)
    coarse, fine = render.render_rays(
        state.params,
        batch.origins,
        batch.dirs,
        key,
        cfg.model,
        cfg.render,
        cfg.camera,
        fine_params=None if prop else state.fine_params,
        randomized=False,
        dtype=_matmul_dtype(cfg),
        prop_params=state.fine_params if prop else None,
        prop_cfg=cfg.proposal,
        # match the training-time sampling distribution: occ-trained
        # fields evaluated with uniform sampling collapse
        grid=state.grid if cfg.render.occ_res > 0 else None,
    )
    out = fine if fine is not None else coarse
    m = render.mse(out.rgb[..., :3], batch.gold[..., :3])
    return {
        "mse": m,
        "psnr": render.psnr_from_mse(m),
        "rgb": out.rgb,
        "depth": out.depth,
        "acc": out.acc,
    }
