"""Data-parallel training + rendering over a device mesh.

shard_map-wrapped versions of the single-device train/eval cores
(train/step.py): each shard computes grads on its local slice of the
ray batch, grads are psum-averaged over the mesh, and the (replicated)
optimizer update is applied identically everywhere — the classic DP
recipe named in SURVEY §5.8. Per-shard PRNG keys are folded with the
shard index so stratified samples differ across devices.

Full-frame novel-view rendering shards pixel tiles along the same axis
(render_sharded); XLA all-gathers the frame on the way out.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import Config
from ..ops import render
from ..train import step as step_mod
from ..train.step import Batch, TrainState
from .mesh import DATA_AXIS, batch_sharding, num_shards, replicated_sharding


def make_dp_train_step(cfg: Config, mesh: Mesh, dataset=None,
                       shard_store: bool = False):
    """Build the jitted DP train step.

    Without ``dataset``: (state, batch, key) -> (state, aux); the batch
    is sharded on rays. With ``dataset`` (a DeviceDataset): the
    per-ray batch sampling happens INSIDE the step, per shard, and the
    signature is (state, images, pose_data, key) -> (state, aux) —
    fusing sampling into the step removes two host dispatches per
    iteration. aux then carries "batch_idx" (sharded) for diagnostics.

    ``shard_store``: the dataset's images/pose_data arrive sharded on
    the VIEW axis over the data mesh (DataConfig.shard_pixel_store) —
    each shard samples rays only from its local views (equal-size
    slices + iid draws == union sampling) and no view data moves
    between devices. batch_idx stays GLOBAL: local view ids are offset by the
    shard's view base, so error stores/diagnostics see one namespace.

    state is replicated. Grad psum happens inside shard_map; Adam runs
    redundantly-replicated (cheap: ~600k params) so no parameter
    collective is needed.
    """
    opt = step_mod.make_optimizer(cfg)
    nshards = num_shards(mesh)
    acc = cfg.train.accumulation_steps
    # On a 1-device mesh the shard_map wrapper only adds dispatch
    # overhead; collapse to the plain jitted step. Numerics are
    # identical: axis_index == 0 and pmean over one shard is the
    # identity.
    single = nshards == 1

    def _axis_index():
        return 0 if single else jax.lax.axis_index(DATA_AXIS)

    def _pmean(x):
        return x if single else jax.lax.pmean(x, DATA_AXIS)
    err_frac = cfg.train.error_resample_frac
    if dataset is not None:
        from ..data.device_dataset import (
            _sample_error_weighted, _sample_per_ray, _sample_per_ray_ms,
            update_error_store,
        )

        multiscale = getattr(dataset, "multiscale_levels", 1) > 1

        per_shard = (cfg.train.num_rays + nshards - 1) // nshards
        # dataset.num_views is the PROCESS-local view count; per-shard
        # sampling sees the full store when replicated, or its
        # global/nshards view block when the store is view-sharded.
        # Global count read off the (global) array shape.
        if shard_store and not single:
            global_views = dataset.images.shape[0]
            assert global_views % nshards == 0, (global_views, nshards)
            shard_views = global_views // nshards
        else:
            shard_store = False
            shard_views = dataset.num_views
        ds_meta = (dataset.mode, dataset.white_background, dataset.camera,
                   dataset.height, dataset.width, shard_views)

    def _local_grads(trainable, batch: Batch, key: jax.Array, grid=None,
                     step=None):
        """Per-shard (possibly micro-batched) gradient computation."""
        if acc <= 1:
            (loss, aux), grads = jax.value_and_grad(
                step_mod.loss_fn, has_aux=True
            )(trainable, batch, key, cfg, grid, step)
            return grads, aux
        n = batch.origins.shape[0]
        micro = n // acc
        mb = jax.tree_util.tree_map(
            lambda x: x[: micro * acc].reshape(acc, micro, *x.shape[1:]), batch
        )
        keys = jax.random.split(key, acc)

        def body(g_sum, xs):
            b, k = xs
            (_, aux_i), g = jax.value_and_grad(step_mod.loss_fn, has_aux=True)(
                trainable, b, k, cfg, grid
            )
            return jax.tree_util.tree_map(jnp.add, g_sum, g), aux_i

        zero = jax.tree_util.tree_map(jnp.zeros_like, trainable)
        g_sum, auxs = jax.lax.scan(body, zero, (mb, keys))
        grads = jax.tree_util.tree_map(lambda g: g / acc, g_sum)
        aux = jax.tree_util.tree_map(lambda a: jnp.mean(a, axis=0), auxs)
        return grads, aux

    def _step(state: TrainState, batch: Batch, key: jax.Array):
        key = jax.random.fold_in(key, _axis_index())
        trainable = step_mod._trainable(state, cfg)
        grads, aux = _local_grads(trainable, batch, key, state.grid,
                                  state.step)
        ray_err = aux.pop("ray_err")  # per-ray, stays sharded
        # gradient sync — mean over shards (each shard already
        # averaged over its local rays, shards hold equal ray counts)
        grads = _pmean(grads)
        aux = _pmean(aux)
        aux["ray_err"] = ray_err
        return step_mod.apply_grads(state, trainable, grads, opt, cfg), aux

    aux_spec = {
        "loss": P(), "loss_coarse": P(), "psnr": P(),
        "ray_err": P(DATA_AXIS),
    }
    if cfg.render.num_fine_samples > 0:
        aux_spec["loss_fine"] = P()
    if cfg.proposal.enabled:
        aux_spec["loss_prop"] = P()
    if cfg.train.distortion_weight > 0:
        aux_spec["loss_dist"] = P()

    if dataset is not None:
        def _step_sampling(state: TrainState, images, pose_data,
                           key: jax.Array):
            k = jax.random.fold_in(key, _axis_index())
            mode, white_bg, camera, h, w, nviews = ds_meta
            sampler = _sample_per_ray_ms if multiscale else _sample_per_ray
            batch = sampler(
                images, pose_data, jax.random.fold_in(k, 0), per_shard,
                mode, white_bg, camera, h, w, nviews,
            )
            if shard_store:
                # local -> global pixel ids (view block base per shard)
                batch = batch._replace(
                    idx=batch.idx + _axis_index() * (nviews * h * w)
                )
            trainable = step_mod._trainable(state, cfg)
            grads, aux = _local_grads(
                trainable, batch, jax.random.fold_in(k, 1), state.grid,
                state.step,
            )
            ray_err = aux.pop("ray_err")
            grads = _pmean(grads)
            aux = _pmean(aux)
            aux["ray_err"] = ray_err
            aux["batch_idx"] = batch.idx
            new_state = step_mod.apply_grads(state, trainable, grads, opt, cfg)
            return new_state, aux

        def _step_err(state: TrainState, images, pose_data, err_store,
                      key: jax.Array):
            """Error-weighted in-step sampling (BASELINE config 5):
            every shard draws from the GLOBAL per-pixel error
            distribution (store replicated — incompatible with
            shard_store by construction), then all shards apply the
            IDENTICAL all-gathered EMA scatter so their store copies
            never diverge."""
            k = jax.random.fold_in(key, _axis_index())
            mode, white_bg, camera, h, w, nviews = ds_meta
            num_err = int(per_shard * err_frac)
            batch = _sample_error_weighted(
                images, pose_data, err_store, jax.random.fold_in(k, 0),
                per_shard, num_err, mode, white_bg, camera, h, w, nviews,
            )
            trainable = step_mod._trainable(state, cfg)
            grads, aux = _local_grads(
                trainable, batch, jax.random.fold_in(k, 1), state.grid,
                state.step,
            )
            ray_err = aux.pop("ray_err")
            grads = _pmean(grads)
            aux = _pmean(aux)
            aux["ray_err"] = ray_err
            aux["batch_idx"] = batch.idx
            if single:
                idx_all, err_all = batch.idx, ray_err
            else:
                idx_all = jax.lax.all_gather(batch.idx, DATA_AXIS,
                                             tiled=True)
                err_all = jax.lax.all_gather(ray_err, DATA_AXIS,
                                             tiled=True)
            new_store = update_error_store(
                err_store, idx_all, err_all, cfg.train.error_resample_ema
            )
            new_state = step_mod.apply_grads(state, trainable, grads, opt, cfg)
            return new_state, aux, new_store

        body = _step_err if err_frac > 0 else _step_sampling
        if single:
            return jax.jit(body, donate_argnums=(0, 3) if err_frac > 0
                           else (0,))
        spec = dict(aux_spec)
        spec["batch_idx"] = P(DATA_AXIS)
        store_spec = P(DATA_AXIS) if shard_store else P()
        out_specs = ((P(), spec, P()) if err_frac > 0 else (P(), spec))
        in_specs = ((P(), store_spec, store_spec, P(), P())
                    if err_frac > 0 else (P(), store_spec, store_spec, P()))
        sharded = jax.shard_map(
            body,
            mesh=mesh,
            in_specs=in_specs,
            out_specs=out_specs,
            check_vma=False,
        )
        return jax.jit(sharded, donate_argnums=(0, 3) if err_frac > 0
                       else (0,))

    if single:
        return jax.jit(_step, donate_argnums=(0,))
    sharded = jax.shard_map(
        _step,
        mesh=mesh,
        in_specs=(P(), P(DATA_AXIS), P()),
        out_specs=(P(), aux_spec),
        check_vma=False,
    )
    return jax.jit(sharded, donate_argnums=(0,))


def default_render_chunk(render_cfg, model_cfg=None) -> int:
    """Render-chunk ray count for a fixed ray-sample memory budget.

    The budget is 65536 rays at 64 samples. A hierarchical union pass
    holds (chunk, S_c+S_f, width) activation temps, so rays scale down
    as the per-ray sample total grows (standalone fine passes run
    sequentially, so their peak is the larger pass, not the sum).
    Power-of-two floored so frame paddings nest.

    Flat-layout hashgrid (arch=hashgrid, hash_brick=False): the render
    program materializes 8 corner gathers per (point, level), so its
    ray-sample budget is 8x smaller (4096 rays x 128 samples).
    """
    s, f = render_cfg.num_samples, render_cfg.num_fine_samples
    s_total = max(s, f) if render_cfg.fine_mode == "standalone" else s + f
    budget = 65536 * 64  # ray-samples per chunk
    if (model_cfg is not None and getattr(model_cfg, "arch", "") == "hashgrid"
            and not getattr(model_cfg, "hash_brick", False)):
        budget //= 8
    chunk = max(4096, min(65536, budget // max(s_total, 1)))
    return 1 << (chunk.bit_length() - 1)


def make_dp_render(cfg: Config, mesh: Mesh, camera=None, chunk: int = 0):
    """Sharded full-frame renderer: rays split across devices, frame
    gathered — the 800x800 novel-view path.

    Returns fn(params, fine_params, origins, dirs, key) -> (rgb, depth,
    acc) over flat ray arrays (caller reshapes to HxW). The per-shard
    ray count must be a multiple of ``chunk`` (render_frame pads);
    chunking runs ON-DEVICE via lax.map — one dispatch and one compile
    per frame shape instead of a host loop — while bounding the
    (rays, samples, width) activation temps of one chunk.

    ``chunk=0`` (default) sizes the chunk to a fixed ray-sample budget
    (default_render_chunk).
    """
    camera = camera or cfg.camera
    dtype = step_mod._matmul_dtype(cfg)
    if chunk <= 0:
        chunk = default_render_chunk(cfg.render, model_cfg=cfg.model)

    # occupancy grids guide RENDER sampling too: a field trained on
    # grid-guided samples has razor-thin surfaces that uniform render
    # sampling misses regardless of field quality
    use_grid = cfg.render.occ_res > 0

    def _render_chunk(params, fine_params, grid, origins, dirs, key):
        prop_params = None
        if cfg.proposal.enabled:
            # the second-net slot carries the proposal MLP (see
            # TrainState.fine_params) — route it to the sampler
            prop_params, fine_params = fine_params, None
        if cfg.render.share_network:
            fine_params = None  # triggers the shared fast fine pass
        coarse, fine = render.render_rays(
            params, origins, dirs, key, cfg.model, cfg.render, camera,
            fine_params=fine_params, randomized=False, dtype=dtype,
            prop_params=prop_params, prop_cfg=cfg.proposal, grid=grid,
        )
        out = fine if fine is not None else coarse
        return out.rgb, out.depth, out.acc

    single = num_shards(mesh) == 1

    def _render(params, fine_params, grid, origins, dirs, key):
        shard = 0 if single else jax.lax.axis_index(DATA_AXIS)
        key = jax.random.fold_in(key, shard)
        n = origins.shape[0]
        if n <= chunk:
            return _render_chunk(params, fine_params, grid, origins, dirs,
                                 key)
        assert n % chunk == 0, (n, chunk)
        oc = origins.reshape(-1, chunk, 3)
        dc = dirs.reshape(-1, chunk, 3)
        rgb, depth, acc = jax.lax.map(
            lambda od: _render_chunk(
                params, fine_params, grid, od[0], od[1], key
            ),
            (oc, dc),
        )
        return rgb.reshape(n, 3), depth.reshape(n), acc.reshape(n)

    def _without_grid(params, fine_params, origins, dirs, key):
        return _render(params, fine_params, None, origins, dirs, key)

    if single:
        return jax.jit(_render if use_grid else _without_grid)
    grid_spec = (P(),) if use_grid else ()
    sharded = jax.shard_map(
        _render if use_grid else _without_grid,
        mesh=mesh,
        in_specs=(P(), P(), *grid_spec, P(DATA_AXIS), P(DATA_AXIS), P()),
        out_specs=(P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
        check_vma=False,
    )
    return jax.jit(sharded)


def place_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Replicate the train state across the mesh."""
    rep = replicated_sharding(mesh)
    return jax.device_put(state, rep)


def place_batch(batch: Batch, mesh: Mesh) -> Batch:
    """Shard a ray batch along the data axis."""
    return jax.device_put(batch, batch_sharding(mesh))
