"""The training driver: trainer owns iteration; eval/logging/checkpoint
are step-counter hooks.

Inverts the reference's control flow (SURVEY §1: minifb's redraw
callback IS the training loop, src/main.rs:56-116 + src/display.rs:19-23)
— an accelerator host has no display, so train() owns the loop and headless
PNG/TensorBoard output replaces the live window. Hook semantics match
the reference exactly: fire when ``iter % N == 0`` for
eval_steps/logging_steps/save_steps (src/main.rs:63,81,85).

--debug renders the GOLD view instead of predictions at eval steps (the
reference's data-pipeline eyeball mode, src/main.rs:99-106);
--eval_on_train evaluates on a training view (src/cli.rs:13-14).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..data.factory import make_dataset
from ..ops import metrics, render as render_ops
from ..parallel import dist_init, dp, mesh as mesh_mod
from ..utils.profiling import Throughput
from ..utils.tb import NullLogger, TBLogger
from ..utils.term import image_preview, sparkline
from . import checkpoint as ckpt
from . import step as step_mod
from .step import TrainState, init_state


def _effective_config(cfg: Config, dataset) -> Config:
    """Adopt the dataset's camera (Blender scenes carry their own
    intrinsics)."""
    if dataset.camera is not cfg.camera:
        return dataclasses.replace(cfg, camera=dataset.camera)
    return cfg


def render_frame(
    cfg: Config,
    state: TrainState,
    origins: jnp.ndarray,
    dirs: jnp.ndarray,
    mesh,
    render_fn=None,
    key: Optional[jax.Array] = None,
    chunk: int = 0,
):
    """Full-frame render via the sharded renderer, chunked to bound
    memory: (H, W) rays -> (H, W, 3) rgb, (H, W) depth, (H, W) acc.

    chunk bounds device memory: each chunk holds (rays, samples, width)
    activation temps. chunk=0 uses dp.default_render_chunk, which also
    scales the chunk down for hierarchical sample totals."""
    if chunk <= 0:
        chunk = dp.default_render_chunk(cfg.render, model_cfg=cfg.model)
    h, w = origins.shape[:2]
    flat_o = origins.reshape(-1, 3)
    flat_d = dirs.reshape(-1, 3)
    n = flat_o.shape[0]
    if render_fn is None:
        render_fn = dp.make_dp_render(cfg, mesh, chunk=chunk)
    key = jax.random.PRNGKey(0) if key is None else key
    # pad so every shard holds a whole number of chunks (the on-device
    # lax.map inside the renderer requires it)
    shards = mesh_mod.num_shards(mesh)
    unit = shards * chunk if n > chunk * shards else shards
    npad = ((n + unit - 1) // unit) * unit
    if npad != n:
        flat_o = jnp.concatenate([flat_o, jnp.zeros((npad - n, 3), flat_o.dtype)])
        flat_d = jnp.concatenate([flat_d, jnp.ones((npad - n, 3), flat_d.dtype)])
    args = [state.params, state.fine_params or state.params]
    if cfg.render.occ_res > 0:
        # grid-guided render sampling (see dp.make_dp_render)
        args.append(state.grid)
    rgb, depth, acc = render_fn(*args, flat_o, flat_d, key)
    return (
        rgb[:n].reshape(h, w, 3),
        depth[:n].reshape(h, w),
        acc[:n].reshape(h, w),
    )


def _log_diagnostics(tb: TBLogger, dataset, cfg: Config, it: int, key,
                     batch=None, state: Optional[TrainState] = None):
    """The reference's logging_steps diagnostics (SURVEY §5.5): screen
    coordinate histograms (logging.rs:13-24), ray-t histograms
    (logging.rs:26-39), query-point occupancy maps on the yx/zx/yz world
    planes (logging.rs:41-107), density histograms/maps
    (logging.rs:109-195), and ray-intersection screen maps
    (logging.rs:197-247).

    ``batch`` is the ACTUAL training batch of this step — its screen
    coords come from Batch.idx (the reference logs the real batch
    distribution, logging.rs:13-24); a fresh diagnostic sample is drawn
    only as a fallback (host-pipeline batches carry no idx)."""
    from ..ops import intersect, sampling

    k = jax.random.fold_in(jax.random.fold_in(key, it), 999)
    if batch is None or batch.idx is None:
        batch = dataset.sample_batch(k, 1024)
    n = min(1024, batch.origins.shape[0])
    origins, dirs = batch.origins[:n], batch.dirs[:n]
    if batch.idx is not None:
        idx = np.asarray(batch.idx[:n])
        xs = idx % dataset.width
        ys = (idx // dataset.width) % dataset.height
        tb.screen_coords(np.stack([xs, ys], -1), it)
    kt = jax.random.fold_in(k, 1)
    if cfg.render.compat_sampling:
        ts = sampling.compat_ts(kt, n, cfg.render.num_samples, cfg.camera.far)
    else:
        ts = sampling.stratified_ts(
            kt, n, cfg.render.num_samples, cfg.camera.near, cfg.camera.far,
            space=cfg.render.sampling_space,
        )
    tb.ray_ts(np.asarray(ts), it)
    pts = sampling.points_from_ts(origins, dirs, ts)
    tb.point_maps(np.asarray(pts), it, prefix="world")
    # ray-intersection screen map over a small ray subset (the reference
    # collects pairwise intersections of two views' rays and paints them
    # to screen, logging.rs:197-247 / ray_sampling.rs:301-359)
    m = min(128, n)
    inter = intersect.pairwise_view_intersections(
        origins[:m], dirs[:m], origins[:m], dirs[:m],
        t_max=cfg.camera.far, tol=1e-3,
    )
    tb.image(
        "intersections",
        np.asarray(
            intersect.trace_intersections_to_screen(
                inter, dataset.width, dataset.height
            )
        ),
        it,
    )
    if state is not None:
        # density histogram + density-weighted maps (log_densities /
        # log_density_maps, src/logging.rs:109-195)
        from ..models.mlp import apply_nerf

        sigma, _ = apply_nerf(state.params, pts, dirs[:, None, :], cfg.model)
        tb.histogram("density", np.asarray(sigma), it)
        tb.point_maps(np.asarray(pts), it, weights=np.asarray(sigma),
                      prefix="density")


def _scene_cfg(cfg: Config, spec: str) -> Config:
    """Per-scene config from a --scenes spec: a known dataset name
    selects that dataset; anything else is an img_dir for the
    configured dataset type."""
    if spec in ("sphere", "flat_sphere", "multiview_png", "blender"):
        data = dataclasses.replace(cfg.data, dataset=spec)
    else:
        data = dataclasses.replace(cfg.data, img_dir=spec)
    return dataclasses.replace(cfg, data=data)


def train_multiscene(
    cfg: Config,
    scene_specs=None,
    datasets=None,
    on_step: Optional[Callable[[int, Dict[str, float]], None]] = None,
) -> TrainState:
    """Multi-scene training (BASELINE config 5): one radiance
    field per scene over a 2-D (scene, data) mesh — scene groups advance
    independent scenes with zero cross-group collectives; rays are
    data-parallel within each group (parallel/multiscene.py).

    The reference's driver exposes everything from one binary
    (src/main.rs:26-117); this is the multi-scene analogue of train():
    stacked init/checkpointing, per-scene losses and eval PSNR, same
    mod-N hook semantics. Returns the stacked TrainState.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..parallel import multiscene as ms_mod
    from ..parallel.mesh import DATA_AXIS, SCENE_AXIS

    dist_init.initialize()
    primary = dist_init.is_primary()
    if datasets is None:
        assert scene_specs, "train_multiscene needs scene_specs or datasets"
        datasets = [
            make_dataset(_scene_cfg(cfg, s)) for s in scene_specs
        ]
    n_scenes = len(datasets)
    assert n_scenes >= 1
    mesh = mesh_mod.make_scene_mesh(n_scenes, cfg.num_devices)
    data_shards = mesh.shape[DATA_AXIS]
    cfg = _effective_config(cfg, datasets[0])

    run_id = cfg.run_name or str(int(time.time()))
    tb = TBLogger(cfg.log_dir, run_id) if primary else NullLogger()
    tb.hparams(cfg.hparams())
    if primary:
        with open(os.path.join(tb.dir, "config.json"), "w") as f:
            f.write(cfg.to_json())

    key = jax.random.PRNGKey(cfg.train.seed)
    state = ms_mod.init_multiscene_state(key, cfg, n_scenes)
    load_path = cfg.load_path or ckpt.latest_checkpoint(cfg.save_dir)
    if load_path:
        state = ckpt.restore(load_path, state)
        print(f"resumed from {load_path} at step {int(state.step[0])}")
    state = jax.device_put(state, NamedSharding(mesh, P(SCENE_AXIS)))
    step_fn = ms_mod.make_multiscene_train_step(cfg, mesh, n_scenes)
    sampler = ms_mod.MultiSceneSampler(datasets)
    num_rays = ((cfg.train.num_rays + data_shards - 1) // data_shards
                ) * data_shards
    batch_sharding = NamedSharding(mesh, P(SCENE_AXIS, DATA_AXIS))

    # per-scene eval renders run single-device (frames are small; the
    # mesh is busy holding scene groups)
    mesh1 = mesh_mod.make_mesh(1)
    render_fn = dp.make_dp_render(cfg, mesh1)

    def _eval_all(it):
        psnrs = []
        for s in range(n_scenes):
            st = step_mod.with_ema_params(
                jax.device_get(ms_mod.scene_state(state, s)))
            o, d = datasets[s].view_rays(0)
            rgb, _, _ = render_frame(cfg, st, o, d, mesh1, render_fn)
            p = float(render_ops.psnr(rgb, datasets[s].view_gold(0)))
            psnrs.append(p)
            tb.scalars({f"psnr_eval/scene_{s}": p}, it)
        if primary:
            joined = ", ".join(f"{p:.2f}" for p in psnrs)
            print(f"iter={it}, per-scene eval psnr=[{joined}]")
            if cfg.live_preview:
                print(image_preview(np.asarray(rgb)))
        return psnrs

    start = int(jax.device_get(state.step).reshape(-1)[0])
    if not cfg.do_train:
        return jax.device_get(state)
    for it in range(start, cfg.train.num_iter):
        k = jax.random.fold_in(key, it)
        batch = jax.device_put(
            sampler.sample(jax.random.fold_in(k, 0), num_rays),
            batch_sharding,
        )
        state, aux = step_fn(state, batch, jax.random.fold_in(k, 1))
        if primary and it % 50 == 0:
            losses = np.asarray(jax.device_get(aux["loss"]))
            joined = ", ".join(f"{l:.5f}" for l in losses)
            print(f"iter={it}, per-scene loss=[{joined}]")
        if it % cfg.train.logging_steps == 0 and it > 0:
            for s, l in enumerate(np.asarray(jax.device_get(aux["loss"]))):
                tb.scalars({f"loss/scene_{s}": float(l)}, it)
            if on_step:
                on_step(it, {"loss": float(np.mean(np.asarray(aux["loss"])))})
        if cfg.eval_on_train and it % cfg.train.eval_steps == 0 and it > 0:
            _eval_all(it)
        if primary and it % cfg.train.save_steps == 0 and it > 0:
            path = ckpt.save(state, cfg.save_dir)
            print(f"saved {path}")

    _eval_all(cfg.train.num_iter)
    if primary:
        ckpt.save(state, cfg.save_dir)
    tb.flush()
    tb.close()
    return jax.device_get(state)


def train(
    cfg: Config,
    dataset=None,
    eval_dataset=None,
    on_step: Optional[Callable[[int, Dict[str, float]], None]] = None,
) -> TrainState:
    """Run the full training loop; returns the final TrainState."""
    # multi-host: every process initializes the collective runtime
    # BEFORE touching devices (no-op single-process); only the primary
    # writes checkpoints/TB (SURVEY §5.8 plan)
    dist_init.initialize()
    primary = dist_init.is_primary()
    mesh = mesh_mod.make_mesh(cfg.num_devices)
    nchips = mesh_mod.num_shards(mesh)
    # per-ray mode: fuse batch sampling INTO the jitted step (one
    # dispatch/iter instead of separate sample and place dispatches). Error resampling fuses
    # too (dp._step_err): the store rides the step as a donated device
    # arg and updates via an identical all-gathered scatter per shard.
    fused_sampling = cfg.data.batch_mode == "per_ray"
    fused_err = fused_sampling and cfg.train.error_resample_frac > 0
    # view-sharded pixel store (DataConfig.shard_pixel_store): each
    # DEVICE holds views/ndev views and samples locally — stores
    # scale past one device/host's memory. Needs in-step sampling and a
    # GLOBAL store (the error distribution spans all views).
    shard_store = cfg.data.shard_pixel_store and nchips > 1
    if cfg.data.shard_pixel_store and (
        not fused_sampling or cfg.train.error_resample_frac > 0
    ):
        print("shard_pixel_store ignored: needs batch_mode=per_ray "
              "with no error resampling (store stays replicated)")
        shard_store = False
    if dataset is None:
        # multi-host: each process stores a disjoint view slice of the
        # pixel store (per-ray batches sample iid, so local-slice
        # sampling == union sampling; see data/factory.make_dataset)
        nproc = jax.process_count()
        shard = (jax.process_index(), nproc) if nproc > 1 else None
        store_sharding = (
            mesh_mod.view_sharding(mesh) if shard_store
            else mesh_mod.replicated_sharding(mesh)
        )
        dataset = make_dataset(
            cfg, sharding=store_sharding, process_shard=shard,
            local_multiple=nchips // jax.process_count() if shard_store
            else 1,
        )
    elif shard_store:
        # caller-provided dataset: honor the flag only if its store
        # actually arrived view-sharded
        shard_store = not dataset.images.sharding.is_fully_replicated
    if eval_dataset is None and cfg.data.dataset == "blender":
        # held-out split for the PSNR of record (BASELINE: test PSNR)
        try:
            eval_dataset = make_dataset(
                cfg, split="test", sharding=mesh_mod.replicated_sharding(mesh)
            )
        except FileNotFoundError:
            eval_dataset = None
    cfg = _effective_config(cfg, dataset)

    run_id = cfg.run_name or str(int(time.time()))
    tb = TBLogger(cfg.log_dir, run_id) if primary else NullLogger()
    tb.hparams(cfg.hparams())
    run_dir = tb.dir
    if primary:
        with open(os.path.join(run_dir, "config.json"), "w") as f:
            f.write(cfg.to_json())

    key = jax.random.PRNGKey(cfg.train.seed)
    state = init_state(key, cfg)
    # resume: explicit --load_path wins; else latest in save_dir
    load_path = cfg.load_path or ckpt.latest_checkpoint(cfg.save_dir)
    if load_path:
        state = ckpt.restore(load_path, state)
        print(f"resumed from {load_path} at step {int(state.step)}")
    state = dp.place_state(state, mesh)

    step_fn = dp.make_dp_train_step(
        cfg, mesh, dataset=dataset if fused_sampling else None,
        shard_store=shard_store,
    )
    render_fn = dp.make_dp_render(cfg, mesh)

    num_rays = mesh_mod.pad_to_shards(cfg.train.num_rays, mesh)
    thr = Throughput(num_rays, cfg.render.num_samples +
                     cfg.render.num_fine_samples, nchips)
    losses = []
    start = int(state.step)
    # per-iter losses stay ON DEVICE between chart redraws: one host
    # sync per CHART_STEPS iterations instead of per step, so the host
    # keeps enqueueing steps while the device runs
    pending = []  # [(iter, device scalar)]

    def flush_losses():
        if not pending:
            return
        vals = jax.device_get([v for _, v in pending])
        for (i, _), v in zip(pending, vals):
            v = float(np.asarray(v))
            losses.append(v)
            tb.scalars({"loss": v}, i)
        pending.clear()

    CHART_STEPS = 50

    err_frac = cfg.train.error_resample_frac
    err_store = None
    if err_frac > 0:
        # the error distribution is part of the training trajectory —
        # resume it from the checkpoint sidecar when present
        err_store = ckpt.load_err_store(load_path) if load_path else None
        if err_store is None:
            err_store = dataset.init_error_store()
        err_store = jax.device_put(
            jnp.asarray(err_store), mesh_mod.replicated_sharding(mesh)
        )

    # async host pipeline (batch_mode="host"): background thread +
    # optional C++ gold gather; replaces on-device sampling for scenes
    # whose pixel store shouldn't live in device memory (SURVEY §7 step 7)
    pipeline = None
    if cfg.data.batch_mode == "host" and err_frac <= 0:
        from ..data.pipeline import PrefetchPipeline

        pipeline = PrefetchPipeline(
            dataset.host_images,
            cfg.camera,
            angles=dataset.host_poses if dataset.mode == "angles" else None,
            c2w=dataset.host_poses if dataset.mode == "c2w" else None,
            num_rays=num_rays,
            white_background=dataset.white_background,
            depth=cfg.data.prefetch,
            seed=cfg.train.seed,
            use_native=cfg.data.use_native_loader,
            num_workers=cfg.data.data_workers,
        )

    if not cfg.do_train:
        if pipeline is not None:
            pipeline.close()
        return jax.device_get(state)

    def next_batch(k):
        if err_frac > 0:
            return dataset.sample_batch_error_weighted(
                k, num_rays, err_store, err_frac
            )
        if pipeline is not None:
            return next(pipeline)
        if cfg.data.batch_mode == "multiview":
            # reference batch semantics (src/dataset.rs:63-139)
            return dataset.sample_multiview_batch(
                k, num_rays, cfg.data.views_per_batch
            )
        return dataset.sample_batch(k, num_rays)

    for it in range(start, cfg.train.num_iter):
        # profiler window (SURVEY §5.1: the reference has no tracing;
        # here a Perfetto/TB-viewable trace of a few steady-state steps)
        if cfg.train.profile_steps > 0:
            if it == start + cfg.train.profile_start:
                jax.profiler.start_trace(run_dir)
            if it == start + cfg.train.profile_start + cfg.train.profile_steps:
                jax.profiler.stop_trace()
                print(f"profiler trace written under {run_dir}")
        k = jax.random.fold_in(key, it)
        if fused_err:
            batch = None  # sampled in-step from the error distribution
            state, aux, err_store = step_fn(
                state, dataset.images, dataset.pose_data, err_store, k
            )
        elif fused_sampling:
            batch = None  # sampled in-step; aux carries batch_idx
            state, aux = step_fn(state, dataset.train_store,
                                 dataset.pose_data, k)
        else:
            batch = dp.place_batch(next_batch(jax.random.fold_in(k, 0)), mesh)
            state, aux = step_fn(state, batch, jax.random.fold_in(k, 1))
        if err_frac > 0 and not fused_err:
            from ..data.device_dataset import update_error_store

            err_store = update_error_store(
                err_store, batch.idx, aux["ray_err"], cfg.train.error_resample_ema
            )

        # --- occupancy-grid EMA update (ops/occupancy.py): periodic,
        # outside the jitted step; ~one extra step's worth of MLP work
        # every occ_update_steps ---
        if state.grid is not None and it % cfg.render.occ_update_steps == 0:
            from ..ops import occupancy
            from .step import _matmul_dtype

            g = occupancy.update_grid(
                state.grid, state.params, jax.random.fold_in(k, 777),
                cfg.model, cfg.render.occ_aabb, cfg.render.occ_decay,
                _matmul_dtype(cfg) or jnp.float32,
            )
            state = state._replace(
                grid=jax.device_put(g, mesh_mod.replicated_sharding(mesh))
            )

        # --- per-iter terminal + TB loss (reference main.rs:73-74);
        # values buffered on device, synced per chart redraw ---
        pending.append((it, aux["loss"]))

        if it % CHART_STEPS == 0 and it > start:
            flush_losses()
            if primary:
                print(f"iter={it}, loss={losses[-1]:.6f}  "
                      f"{sparkline(losses[-200:])}")

        # --- logging hook (mod semantics of main.rs:63) ---
        if it % cfg.train.logging_steps == 0 and it > 0:
            flush_losses()
            stats = thr.stats()
            tb.scalars(stats, it)
            tb.scalars({"psnr_train": float(aux["psnr"])}, it)
            thr.reset()
            if primary:
                diag_batch = batch
                if diag_batch is None and "batch_idx" in aux:
                    diag_batch = dataset.batch_from_idx(aux["batch_idx"][:1024])
                _log_diagnostics(tb, dataset, cfg, it, key,
                                 batch=diag_batch, state=state)
            if on_step:
                on_step(it, {**stats, "loss": losses[-1] if losses else float("nan")})

        # --- eval hook: render a frame (main.rs:85-106); uses the
        # held-out split when available, else a training view ---
        if cfg.eval_on_train and it % cfg.train.eval_steps == 0 and it > 0:
            eval_ds = eval_dataset if eval_dataset is not None else dataset
            eval_view = 0
            o, d = eval_ds.view_rays(eval_view)
            # eval sees the EMA weights when --ema_decay > 0 (identity
            # otherwise); the raw weights keep training
            rgb, depth, acc = render_frame(
                cfg, step_mod.with_ema_params(state), o, d, mesh, render_fn)
            gold = eval_ds.view_gold(eval_view)
            m = render_ops.mse(rgb, gold)
            psnr = float(render_ops.psnr_from_mse(m))
            ssim = float(metrics.ssim(rgb[..., :3], gold[..., :3]))
            tb.scalars(
                {"psnr_eval": psnr, "mse_eval": float(m), "ssim_eval": ssim},
                it,
            )
            if cfg.debug:
                # --debug: show gold, to eyeball the data pipeline
                tb.image("prediction", np.asarray(gold), it)
            elif not cfg.log_densities_only:
                tb.image("prediction", np.asarray(rgb), it)
                tb.image("depth", np.asarray(depth / jnp.maximum(depth.max(), 1e-6)), it)
            if primary:
                print(f"iter={it}, eval psnr={psnr:.2f}")
                if cfg.live_preview:
                    # "watch training live", headless: the eval frame as
                    # ANSI half-blocks (reference: display.rs window)
                    print(image_preview(np.asarray(rgb)))

        # --- checkpoint hook (main.rs:81-83); primary-only in
        # multi-host runs (state is replicated, one writer suffices) ---
        if primary and it % cfg.train.save_steps == 0 and it > 0:
            path = ckpt.save(state, cfg.save_dir, err_store=err_store)
            print(f"saved {path}")

        thr.tick()

    flush_losses()
    if primary:
        ckpt.save(state, cfg.save_dir, err_store=err_store)
    if pipeline is not None:
        pipeline.close()
    tb.flush()
    tb.close()
    return jax.device_get(state)
