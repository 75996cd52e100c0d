"""Steady-state training throughput on an NVIDIA GPU.

    python bench.py

Exits non-zero, before measuring anything, unless JAX's first device
is a GPU. Prints the card's name and power limit (nvidia-smi), then ONE
JSON line:
  {"metric": "train_ray_samples_per_sec_per_chip", "value": N,
   "unit": "samples/s", "extras": {...}}

The reference itself publishes no numbers (BASELINE.md). Also reports
novel-view render time for an 800x800 frame and the step times of the
hierarchical, mip-NeRF, record, unbounded and factored configurations.

Flagship config: paper NeRF (PE L=10/4, 8x256+skip, view head),
stratified 64 samples/ray, 4096-ray batches, mixed precision
(bf16 matmuls, f32 master) — BASELINE config 2 — trained by XLA
autodiff of the renderer.
"""

import json
import time

import jax
import jax.numpy as jnp


def flagship_config():
    """The bench-of-record flagship Config, exposed so tests can pin the
    bench path to the CLI path (tests/test_bench_cli_seam.py asserts
    config_from_args resolves to the same hot-path fields)."""
    from nerf_rs_tpu.config import CameraConfig, Config, RenderConfig, TrainConfig

    return Config(
        camera=CameraConfig(width=128, height=128),
        render=RenderConfig(num_samples=64),
        train=TrainConfig(num_rays=4096, precision="mixed"),
    )


def main():
    from nerf_rs_tpu.config import (
        CameraConfig, Config, RenderConfig, TrainConfig,
    )
    from nerf_rs_tpu.data import synthetic
    from nerf_rs_tpu.data.device_dataset import DeviceDataset
    from nerf_rs_tpu.ops import rays as rays_ops
    from nerf_rs_tpu.parallel import dp, mesh as mesh_mod
    from nerf_rs_tpu.train.step import init_state
    from nerf_rs_tpu.train.loop import render_frame
    import numpy as np
    from nerf_rs_tpu.utils.gpu import card_lines, require_gpu

    require_gpu("bench.py", jax.devices()[0].platform)
    cards = card_lines()
    for line in cards:
        print(f"card: {line}", flush=True)
    cfg = flagship_config()
    num_rays = cfg.train.num_rays
    num_samples = cfg.render.num_samples
    mesh = mesh_mod.make_mesh()
    nchips = mesh_mod.num_shards(mesh)

    n_views = 84
    imgs = np.asarray(synthetic.sphere_scene_images(cfg.camera, n_views))
    angles = np.asarray(rays_ops.view_angle_grid(6))
    ds = DeviceDataset(imgs, cfg.camera, angles=angles,
                       sharding=mesh_mod.replicated_sharding(mesh))

    key = jax.random.PRNGKey(0)
    state = dp.place_state(init_state(key, cfg), mesh)
    # batch sampling runs inside the step (one dispatch per iteration)
    step_fn = dp.make_dp_train_step(cfg, mesh, dataset=ds)

    def one_step(state, i):
        return step_fn(state, ds.images, ds.pose_data,
                       jax.random.fold_in(key, i))

    # warmup / compile
    for i in range(5):
        state, aux = one_step(state, i)
    jax.block_until_ready((state, aux))

    # steady state: five windows, the best reported as peak throughput,
    # with all windows in extras
    iters = 100
    windows = []
    base = 5
    for w in range(5):
        t0 = time.perf_counter()
        for i in range(base, base + iters):
            state, aux = one_step(state, i)
        jax.block_until_ready((state, aux))
        windows.append(time.perf_counter() - t0)
        base += iters
    dt = min(windows)

    steps_per_sec = iters / dt
    samples_per_sec_per_chip = steps_per_sec * num_rays * num_samples / nchips

    # secondary: hierarchical BASELINE config 3 (64+128 union, white bg)
    hcfg = Config(
        camera=cfg.camera,
        render=RenderConfig(num_samples=64, num_fine_samples=128,
                            share_network=True, white_background=True),
        train=cfg.train,
    )
    hstate = dp.place_state(init_state(key, hcfg), mesh)
    hstep = dp.make_dp_train_step(hcfg, mesh, dataset=ds)
    for i in range(3):
        hstate, haux = hstep(hstate, ds.images, ds.pose_data,
                             jax.random.fold_in(key, 9000 + i))
    jax.block_until_ready((hstate, haux))
    hwin, hbase = [], 9003
    for w in range(3):
        t0 = time.perf_counter()
        for i in range(hbase, hbase + 50):
            hstate, haux = hstep(hstate, ds.images, ds.pose_data,
                                 jax.random.fold_in(key, i))
        jax.block_until_ready((hstate, haux))
        hwin.append((time.perf_counter() - t0) / 50)
        hbase += 50
    hier_ms = 1000.0 * min(hwin)

    # secondary: the factored fast-field family (--arch factored,
    # gather-free CP multiresolution; models/factored.py) at its
    # 128-sample config — the framework's highest-throughput trainer
    from nerf_rs_tpu.config import ModelConfig
    fcfg = Config(
        camera=cfg.camera,
        model=ModelConfig(arch="factored", sigma_activation="softplus"),
        render=RenderConfig(num_samples=128, white_background=True),
        train=TrainConfig(num_rays=num_rays, precision="mixed",
                          learning_rate=1e-2),
    )
    fstate = dp.place_state(init_state(key, fcfg), mesh)
    fstep = dp.make_dp_train_step(fcfg, mesh, dataset=ds)
    for i in range(3):
        fstate, faux = fstep(fstate, ds.images, ds.pose_data,
                             jax.random.fold_in(key, 20000 + i))
    jax.block_until_ready((fstate, faux))
    fwin, fbase = [], 20003
    for w in range(3):
        t0 = time.perf_counter()
        for i in range(fbase, fbase + 50):
            fstate, faux = fstep(fstate, ds.images, ds.pose_data,
                                 jax.random.fold_in(key, i))
        jax.block_until_ready((fstate, faux))
        fwin.append((time.perf_counter() - t0) / 50)
        fbase += 50
    fac_ms = 1000.0 * min(fwin)
    fac_sps = num_rays * 128 / min(fwin) / nchips

    # secondary: mip-NeRF IPE (anti-aliased) training — the mipnerf
    # preset shape (64+128 standalone, softplus, white bg)
    mcfg = Config(
        camera=cfg.camera,
        model=ModelConfig(ipe=True, sigma_activation="softplus"),
        render=RenderConfig(num_samples=64, num_fine_samples=128,
                            share_network=True, fine_mode="standalone",
                            white_background=True),
        train=cfg.train,
    )
    mstate = dp.place_state(init_state(key, mcfg), mesh)
    mstep = dp.make_dp_train_step(mcfg, mesh, dataset=ds)
    for i in range(3):
        mstate, maux = mstep(mstate, ds.images, ds.pose_data,
                             jax.random.fold_in(key, 30000 + i))
    jax.block_until_ready((mstate, maux))
    mwin, mbase = [], 30003
    for w in range(3):
        t0 = time.perf_counter()
        for i in range(mbase, mbase + 50):
            mstate, maux = mstep(mstate, ds.images, ds.pose_data,
                                 jax.random.fold_in(key, i))
        jax.block_until_ready((mstate, maux))
        mwin.append((time.perf_counter() - t0) / 50)
        mbase += 50
    mip_ms_step = 1000.0 * min(mwin)

    # secondary: the record-recipe shape — union fine merge
    # (S + S_f + 1 = 193 merged intervals)
    rcfg2 = Config(
        camera=cfg.camera,
        model=ModelConfig(ipe=True, sigma_activation="softplus"),
        render=RenderConfig(num_samples=64, num_fine_samples=128,
                            share_network=True, fine_mode="union",
                            white_background=True),
        train=cfg.train,
    )
    rstate = dp.place_state(init_state(key, rcfg2), mesh)
    rstep = dp.make_dp_train_step(rcfg2, mesh, dataset=ds)
    for i in range(3):
        rstate, raux = rstep(rstate, ds.images, ds.pose_data,
                             jax.random.fold_in(key, 50000 + i))
    jax.block_until_ready((rstate, raux))
    rwin, rbase = [], 50003
    for w in range(3):
        t0 = time.perf_counter()
        for i in range(rbase, rbase + 50):
            rstate, raux = rstep(rstate, ds.images, ds.pose_data,
                                 jax.random.fold_in(key, i))
        jax.block_until_ready((rstate, raux))
        rwin.append((time.perf_counter() - t0) / 50)
        rbase += 50
    record_ms = 1000.0 * min(rwin)

    # secondary: the mip-NeRF 360 unbounded recipe (--preset unbounded:
    # radius-2 contraction + disparity spacing + 2-level annealed
    # proposal + distortion) at the record batch shape —
    # the rebuild's flagship capability delta over the reference
    # (which hard-bounds every ray, src/ray_sampling.rs:107-125)
    from nerf_rs_tpu.config import ProposalConfig
    ucfg = Config(
        camera=CameraConfig(width=128, height=128, near=0.3, far=60.0),
        model=ModelConfig(contract=True, sigma_activation="softplus"),
        render=RenderConfig(num_samples=64, num_fine_samples=0,
                            sampling_space="disparity",
                            white_background=False),
        train=TrainConfig(num_rays=num_rays, precision="mixed",
                          distortion_weight=0.01),
        proposal=ProposalConfig(enabled=True, num_samples=64,
                                num_levels=2, anneal_steps=1000),
    )
    ustate = dp.place_state(init_state(key, ucfg), mesh)
    ustep = dp.make_dp_train_step(ucfg, mesh, dataset=ds)
    for i in range(3):
        ustate, uaux = ustep(ustate, ds.images, ds.pose_data,
                             jax.random.fold_in(key, 40000 + i))
    jax.block_until_ready((ustate, uaux))
    uwin, ubase = [], 40003
    for w in range(3):
        t0 = time.perf_counter()
        for i in range(ubase, ubase + 50):
            ustate, uaux = ustep(ustate, ds.images, ds.pose_data,
                                 jax.random.fold_in(key, i))
        jax.block_until_ready((ustate, uaux))
        uwin.append((time.perf_counter() - t0) / 50)
        ubase += 50
    unbounded_ms = 1000.0 * min(uwin)

    # secondary: 800x800 novel-view render (coarse-only flagship)
    rcam = CameraConfig(width=800, height=800)
    pose = rays_ops.pose_from_yaw_pitch(jnp.float32(0.3), jnp.float32(0.2))
    o, d = rays_ops.ray_grid(pose, rcam)
    render_cfg = Config(camera=rcam, render=cfg.render, train=cfg.train)
    render_fn = dp.make_dp_render(render_cfg, mesh)
    # compile (render_frame's default chunk matches make_dp_render's)
    rgb, _, _ = render_frame(render_cfg, state, o, d, mesh, render_fn)
    jax.block_until_ready(rgb)
    # best of 3
    render_windows = []
    for _ in range(3):
        t0 = time.perf_counter()
        rgb, _, _ = render_frame(render_cfg, state, o, d, mesh, render_fn)
        jax.block_until_ready(rgb)
        render_windows.append(time.perf_counter() - t0)
    render_s = min(render_windows)

    print(json.dumps({
        "metric": "train_ray_samples_per_sec_per_chip",
        "value": round(samples_per_sec_per_chip, 1),
        "unit": "samples/s",
        "extras": {
            "steps_per_sec": round(steps_per_sec, 2),
            "step_time_ms": round(1000.0 * dt / iters, 3),
            "window_step_ms": [round(1000.0 * w / iters, 2) for w in windows],
            "num_chips": nchips,
            "render_800x800_s": round(render_s, 3),
            "render_windows_s": [round(w, 3) for w in render_windows],
            "hier_64_128_step_ms": round(hier_ms, 2),
            "mipnerf_64_128_step_ms": round(mip_ms_step, 2),
            "record_union_ipe_step_ms": round(record_ms, 2),
            "unbounded_prop2x64_step_ms": round(unbounded_ms, 2),
            "factored_128_step_ms": round(fac_ms, 2),
            "factored_samples_per_sec_per_chip": round(fac_sps, 1),
            "device": str(jax.devices()[0].device_kind),
            "card": cards,
        },
    }))


if __name__ == "__main__":
    # share the CLI's persistent XLA compile cache
    from nerf_rs_tpu.cli import enable_compile_cache

    enable_compile_cache()
    main()
