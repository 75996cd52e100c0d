"""CLI: ``train`` and ``render`` subcommands preserving the reference's
16-flag surface (src/cli.rs:5-66) and extending it with the model/render
knobs that were compile-time consts in the reference (src/model.rs:7-13).

  python -m nerf_rs_tpu.cli train --dataset sphere --num_iter 1000
  python -m nerf_rs_tpu.cli render --load_path ckpt.npz --frames 40

The reference's bare binary both trains and displays; here ``render``
is the explicit novel-view entry point (the capability of the
commented draw_valid_predictions, src/display.rs:55-94, and the
40-frame spherical sweep of BASELINE config 4).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time

import numpy as np


def _bool_flag(p, name, default, help=""):
    p.add_argument(
        f"--{name}",
        type=lambda s: s.lower() in ("1", "true", "yes"),
        default=default,
        help=help + f" (default {default})",
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nerf_rs_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    common = argparse.ArgumentParser(add_help=False)
    # --- the reference's 16 flags (src/cli.rs:5-66) ---
    _bool_flag(common, "debug", False, "render gold instead of predictions")
    _bool_flag(common, "do_train", True)
    _bool_flag(common, "eval_on_train", True)
    _bool_flag(common, "live_preview", False,
               "print eval frames in-terminal (ANSI half-blocks) — the "
               "headless form of the reference's live window")
    _bool_flag(common, "log_densities_only", False)
    common.add_argument("--img_dir", default="data/monkey-128-no-shading-2d-6")
    common.add_argument("--view_start", type=int, default=0)
    common.add_argument("--view_end", type=int, default=84)
    common.add_argument("--view_step", type=int, default=1)
    common.add_argument("--num_views_per_hemisphere", type=int, default=6)
    common.add_argument("--log_dir", default="logs")
    common.add_argument("--save_dir", default="checkpoints")
    common.add_argument("--load_path", default="")
    common.add_argument("--num_iter", type=int, default=50_000)
    common.add_argument("--eval_steps", type=int, default=101)
    common.add_argument("--logging_steps", type=int, default=101)
    common.add_argument("--save_steps", type=int, default=1001)
    common.add_argument("--learning_rate", type=float, default=5e-4)
    common.add_argument("--lr_decay_steps", type=int, default=0,
                        help="exponential decay horizon (0 = constant lr, reference behavior)")
    common.add_argument("--lr_final", type=float, default=5e-6)
    common.add_argument("--ema_decay", type=float, default=0.0,
                        help="EMA of the trainable weights for eval/"
                        "render (0 = off). Choose so the averaging "
                        "window 1/(1-d) is a small fraction of "
                        "num_iter (0.999 for 30k iters); averaging "
                        "most of a fast-moving trajectory renders "
                        "garbage (measured)")
    # --- rebuild extensions ---
    common.add_argument(
        "--dataset",
        default="multiview_png",
        choices=["multiview_png", "blender", "llff", "sphere",
                 "flat_sphere"],
    )
    common.add_argument("--llff_factor", type=int, default=1,
                        help="LLFF image downsample factor (loads "
                             "images_{factor}/ when present)")
    common.add_argument("--llff_holdout", type=int, default=8,
                        help="every Nth LLFF view is test (0 = none)")
    common.add_argument("--width", type=int, default=128)
    common.add_argument("--height", type=int, default=128)
    common.add_argument("--near", type=float, default=0.05)
    common.add_argument("--far", type=float, default=2.0)
    _bool_flag(common, "ndc", False,
               "NDC ray reparameterization (NeRF appendix C, forward-"
               "facing/LLFF captures): warps rays so sampling covers "
               "the unit NDC depth range disparity-linearly; requires "
               "--near 0 --far 1 (auto-set when --ndc is given without "
               "explicit near/far)")
    common.add_argument("--ndc_near", type=float, default=1.0,
                        help="world near-plane distance of the NDC warp")
    common.add_argument("--num_rays", type=int, default=4096)
    common.add_argument("--num_samples", type=int, default=64)
    common.add_argument("--num_fine_samples", type=int, default=0)
    _bool_flag(common, "share_network", False,
               "one MLP for both hierarchical passes: the fine pass "
               "evaluates only the new samples (fast path)")
    common.add_argument(
        "--fine_mode", default="union", choices=["union", "standalone"],
        help="union: composite coarse+fine samples (paper); standalone: "
             "composite only the fine samples (proposal-style fast path)",
    )
    _bool_flag(common, "white_background", False)
    common.add_argument("--occ_res", type=int, default=0,
                        help="occupancy-grid resolution for empty-space "
                             "skipping (0 = off; 64 typical)")
    common.add_argument("--occ_update_steps", type=int, default=16,
                        help="grid EMA update cadence")
    common.add_argument("--occ_threshold", type=float, default=1e-2,
                        help="raw-sigma occupancy cutoff")
    common.add_argument("--occ_aabb", type=float, default=1.0,
                        help="scene AABB half-extent")
    common.add_argument("--occ_bins", type=int, default=64,
                        help="ray bins tested against the grid per draw")
    common.add_argument("--occ_decay", type=float, default=0.95,
                        help="per-update EMA decay (NerfAcc default)")
    common.add_argument("--occ_uniform_frac", type=float, default=0.25,
                        help="uniform floor blended into the occupancy "
                             "PDF (0.10 = measured edge for tuned runs; "
                             "0 collapses on sparse scenes)")
    common.add_argument(
        "--arch", default="nerf", choices=["nerf", "hashgrid", "factored"],
        help="architecture family: paper NeRF (PE + 8x256 MLP), "
             "Instant-NGP hash encoding + tiny MLPs (models/hashgrid"
             ".py), or gather-free CP-factored multiresolution lines "
             "(models/factored.py)",
    )
    _bool_flag(common, "contract", False,
               "mip-NeRF 360 scene contraction (unbounded scenes): "
               "sample positions map into the radius-2 ball before "
               "encoding, far content compressing as 1/distance "
               "(ops/contract.py; pair with --sampling_space disparity "
               "— --preset unbounded for the full recipe)")
    common.add_argument(
        "--sampling_space", default="linear",
        choices=["linear", "disparity"],
        help="stratification space for the uniform sample draw: linear "
             "(NeRF eq. 2) or disparity (even in 1/t, the mip-NeRF 360 "
             "unbounded spacing; requires --near > 0)")
    _bool_flag(common, "ipe", False,
               "mip-NeRF integrated positional encoding: anti-aliased "
               "conical-frustum interval sampling (arch=nerf, XLA path; "
               "--preset mipnerf for the full recipe)")
    common.add_argument(
        "--multiscale_levels", type=int, default=1,
        help="mip-NeRF multiscale training: >1 samples each batch "
             "across a 1/1..1/2^(L-1) box pyramid, rays carrying their "
             "level's cone radius (pairs with --ipe; also the paper's "
             "point-sampled multiscale baseline without it)")
    common.add_argument("--hash_levels", type=int, default=16,
                        help="hashgrid resolution levels")
    common.add_argument("--hash_table_log2", type=int, default=19,
                        help="log2 entries per hash level")
    common.add_argument("--hash_base_res", type=int, default=16)
    common.add_argument("--hash_max_res", type=int, default=1024)
    common.add_argument("--hash_aabb", type=float, default=1.6,
                        help="hash grid AABB half-extent")
    _bool_flag(common, "hash_brick", False,
               "brick table layout: one contiguous 512 B row gather per "
               "(point, level) instead of 8 scattered corner pairs "
               "(models/hashgrid.brick_encode); same parameter count")
    common.add_argument("--fac_levels", type=int, default=6,
                        help="factored-family resolution-ladder levels")
    common.add_argument("--fac_base_res", type=int, default=16)
    common.add_argument("--fac_max_res", type=int, default=512,
                        help="finest factored line resolution")
    common.add_argument("--fac_comps", type=int, default=48,
                        help="CP rank (per-axis matmul channels)")
    common.add_argument("--fac_aabb", type=float, default=1.6,
                        help="factored field AABB half-extent")
    common.add_argument("--fac_l1", type=float, default=0.0,
                        help="L1 penalty on the factored line tables "
                             "(TensoRF grid sparsity; suppresses CP "
                             "axis-streak fog)")
    common.add_argument(
        "--sigma_activation", default="relu",
        choices=["relu", "softplus"],
        help="density activation (softplus recommended for hashgrid)",
    )
    _bool_flag(common, "use_proposal", False,
               "proposal-network sampling (mip-NeRF 360 lineage): a tiny "
               "density MLP picks the main network's samples; trained "
               "with the interlevel bound loss (requires "
               "num_fine_samples=0)")
    common.add_argument("--proposal_samples", type=int, default=64,
                        help="uniform samples the proposal MLP evaluates")
    common.add_argument("--proposal_levels", type=int, default=1,
                        help="resampling rounds through the shared "
                             "proposal MLP (mip-NeRF 360 runs 2); the "
                             "interlevel loss sums over levels")
    common.add_argument("--proposal_depth", type=int, default=4)
    common.add_argument("--proposal_width", type=int, default=64)
    common.add_argument("--proposal_anneal_steps", type=int, default=0,
                        help="mip-NeRF 360 resampling annealing horizon "
                             "(0 = off)")
    common.add_argument("--accumulation_steps", type=int, default=1)
    common.add_argument(
        "--batch_mode", default="per_ray",
        choices=["per_ray", "multiview", "host"],
        help="per_ray: iid on-device sampling; multiview: reference "
             "semantics (views_per_batch views, rays split evenly, "
             "src/dataset.rs:63-139); host: async PrefetchPipeline with "
             "optional C++ gold gather",
    )
    common.add_argument("--views_per_batch", type=int, default=4,
                        help="distinct views per batch (multiview mode)")
    common.add_argument("--prefetch", type=int, default=2,
                        help="host-pipeline buffered batches")
    common.add_argument("--data_workers", type=int, default=1,
                        help="parallel host assembly threads (host mode)")
    _bool_flag(common, "use_native_loader", True,
               "C++ batch assembler for host-mode gold gather")
    _bool_flag(common, "shard_pixel_store", False,
               "shard the pixel store's view axis over the device mesh "
               "(pod stores beyond one device/host's memory; per_ray "
               "batch mode)")
    common.add_argument(
        "--scenes", default="",
        help="comma-separated scene list for multi-scene pod training "
             "(BASELINE config 5): each entry is a dataset name "
             "(sphere/flat_sphere) or an img_dir for --dataset; one "
             "radiance field per scene, scene axis sharded over a "
             "(scene, data) mesh",
    )
    common.add_argument("--distortion_weight", type=float, default=0.0,
                        help="mip-NeRF 360 distortion loss weight on the "
                             "finest pass (0 = off; the paper uses 0.01)")
    common.add_argument("--error_resample_frac", type=float, default=0.0,
                        help="fraction of rays drawn from the per-pixel error distribution")
    common.add_argument("--error_resample_ema", type=float, default=0.5)
    common.add_argument("--profile_steps", type=int, default=0,
                        help="trace N steady-state steps with jax.profiler")
    common.add_argument("--precision", default="mixed", choices=["f32", "bf16", "mixed"])
    common.add_argument("--seed", type=int, default=0)
    common.add_argument("--num_devices", type=int, default=0)
    common.add_argument("--run_name", default="")
    _bool_flag(common, "compat", False, "reference-compat math (8x100 MLP, sigma-grayscale)")

    _bool_flag(common, "debug_nans", False, "enable jax_debug_nans")
    common.add_argument(
        "--preset", default="",
        choices=["", "tiny", "full", "hierarchical", "record", "proposal",
                 "pod", "ngp", "factored", "mipnerf", "unbounded"],
        help="BASELINE.json config presets: tiny = 100x100 coarse-only "
             "4096-ray fit (config 1); full = paper NeRF, stratified 64 "
             "(config 2); hierarchical = coarse 64 + fine 128, white bg "
             "(config 3); proposal = tiny-proposal-guided 128 samples; "
             "record = IPE intervals on occ-guided coarse sampling + "
             "union fine; "
             "pod = DP + highest-error resampling (config 5); "
             "ngp = Instant-NGP hash-grid field; factored = gather-free "
             "CP multiresolution field; "
             "mipnerf = anti-aliased IPE interval sampling "
             "(64+128 standalone, one MLP); unbounded = mip-NeRF 360 "
             "scene contraction + disparity sampling + annealed "
             "2-level proposal + distortion loss (360-degree unbounded "
             "captures)",
    )

    # train / render / eval / export subcommands (reference surface +
    # the inference/inspection entry points it lacked)
    sub.add_parser("train", parents=[common])

    pr = sub.add_parser("render", parents=[common])
    pr.add_argument("--scene_index", type=int, default=0,
                    help="which scene of a --scenes stacked checkpoint")
    pr.add_argument("--frames", type=int, default=40, help="spherical sweep length")
    pr.add_argument("--pitch", type=float, default=math.pi / 6)
    pr.add_argument("--out_dir", default="renders")
    pr.add_argument("--view", type=int, default=-1, help="render one dataset view instead of a sweep")
    _bool_flag(pr, "gif", False, "also write an animated sweep.gif")
    _bool_flag(pr, "depth", False,
               "also write depth (expected termination distance, "
               "normalized by far) and acc (opacity) maps per frame")

    pe = sub.add_parser("eval", parents=[common])
    pe.add_argument("--scene_index", type=int, default=0,
                    help="which scene of a --scenes stacked checkpoint")
    pe.add_argument("--split", default="test", help="dataset split (blender) to evaluate")
    pe.add_argument("--max_views", type=int, default=0, help="0 = all views")
    pe.add_argument("--out_dir", default="", help="optionally dump per-view renders")
    pe.add_argument(
        "--scales", default="",
        help="comma-separated integer downscales (e.g. 1,2,4,8): render "
             "each view at H/s x W/s against box-downsampled gold and "
             "report per-scale PSNR — the mip-NeRF multiscale "
             "anti-aliasing benchmark (--ipe models widen their pixel "
             "footprint with s; point-sampled models alias)")

    px = sub.add_parser("export", parents=[common])
    px.add_argument("--scene_index", type=int, default=0,
                    help="which scene of a --scenes stacked checkpoint")
    px.add_argument("--grid_res", type=int, default=128,
                    help="density grid resolution per axis")
    px.add_argument("--export_aabb", type=float, default=1.6,
                    help="half-extent of the sampled cube")
    px.add_argument("--threshold", type=float, default=5.0,
                    help="sigma cutoff for the .ply point cloud")
    px.add_argument("--out", default="export/field",
                    help="output prefix; writes <out>.npz and <out>.ply")
    _bool_flag(px, "mesh", False,
               "also extract a triangle mesh (marching tetrahedra at "
               "the --threshold isosurface) to <out>_mesh.ply")
    return p


def explicit_dests(argv) -> set:
    """Dest names the user explicitly passed in ``argv``.

    Re-parses with every default set to SUPPRESS, so only flags that
    actually appeared on the command line land in the namespace —
    presets must never clobber an explicit user flag."""
    p = build_parser()
    stack = [p]
    while stack:
        parser = stack.pop()
        for a in parser._actions:
            if isinstance(a, argparse._SubParsersAction):
                stack.extend(a.choices.values())
            else:
                a.default = argparse.SUPPRESS
    ns, _ = p.parse_known_args(argv)
    return set(vars(ns))


def _apply_preset(args):
    """Overlay the named BASELINE config onto parsed args before
    building the Config. Precedence: explicit user flags (recorded in
    ``args._explicit`` by main()) beat the preset; the preset beats
    parser defaults. ``--preset hierarchical --num_samples 32`` keeps
    the user's 32."""
    p = getattr(args, "preset", "")
    explicit = getattr(args, "_explicit", set())

    def _set(**kw):
        for name, value in kw.items():
            if name not in explicit:
                setattr(args, name, value)

    if getattr(args, "ndc", False):
        # NDC warps rays to the unit depth range; pick it up for the
        # user unless they set near/far themselves (Config validates)
        _set(near=0.0, far=1.0)

    if p == "tiny":
        _set(width=100, height=100, num_rays=4096, num_samples=64,
             num_fine_samples=0)
    elif p == "full":
        _set(num_samples=64, num_fine_samples=0)
    elif p == "hierarchical":
        _set(num_samples=64, num_fine_samples=128, white_background=True)
    elif p == "record":
        # the paper-family quality composition: mip-NeRF IPE on
        # occ-guided interval edges + union fine (S + S_f + 1 = 193
        # merged intervals in the fine pass)
        _set(ipe=True, share_network=True, fine_mode="union",
             num_samples=64, num_fine_samples=128,
             sigma_activation="softplus", white_background=True,
             occ_res=32, occ_aabb=1.6, occ_uniform_frac=0.10)
    elif p == "proposal":
        # tiny proposal picks 128 main samples; the 1k-step anneal keeps
        # the sampler from locking onto the half-trained field
        _set(num_samples=128, num_fine_samples=0, use_proposal=True,
             proposal_samples=64, white_background=True,
             proposal_anneal_steps=1000)
    elif p == "pod":
        _set(error_resample_frac=max(args.error_resample_frac, 0.5))
    elif p == "ngp":
        # Instant-NGP family (models/hashgrid.py): hash tables learn at
        # much higher lr than MLPs (paper §4); softplus keeps density
        # gradients alive through the sparse table entries. The preset
        # uses the brick table layout; --hash_brick false selects the
        # paper's flat layout
        _set(arch="hashgrid", sigma_activation="softplus",
             hash_brick=True,
             learning_rate=1e-2, num_samples=128,
             white_background=True)
    elif p == "factored":
        # CP-factored multiresolution field (models/factored.py): the
        # gather-free fast family; grids learn at high lr like the ngp
        # preset
        _set(arch="factored", sigma_activation="softplus",
             learning_rate=1e-2, num_samples=128,
             white_background=True)
    elif p == "unbounded":
        # mip-NeRF 360 unbounded recipe (arXiv 2111.12077): radius-2
        # scene contraction + disparity-spaced sampling + annealed
        # proposal resampling + distortion loss in disparity-s space.
        # near/far bracket the procedural lego360 scene (data/
        # procedural.field_360); override for other captures.
        _set(contract=True, sampling_space="disparity", near=0.3,
             far=60.0, use_proposal=True, proposal_samples=64,
             proposal_levels=2, num_samples=64, num_fine_samples=0,
             proposal_anneal_steps=1000, distortion_weight=0.01,
             sigma_activation="softplus", white_background=False)
    elif p == "mipnerf":
        # mip-NeRF (arXiv 2103.13415): IPE conical-frustum intervals,
        # ONE MLP for both levels, fine intervals composited standalone
        # (the paper's own scheme); softplus density per the paper.
        _set(ipe=True, share_network=True, fine_mode="standalone",
             num_samples=64, num_fine_samples=128,
             sigma_activation="softplus", white_background=True)
    return args


def config_from_args(args) -> "Config":
    args = _apply_preset(args)
    from .config import (
        CameraConfig,
        Config,
        DataConfig,
        ModelConfig,
        RenderConfig,
        ProposalConfig,
        TrainConfig,
        reference_compat_config,
    )

    if args.compat:
        base = reference_compat_config()
        model, render_cfg = base.model, base.render
        render_cfg = dataclasses.replace(
            render_cfg, num_samples=args.num_samples,
        )
    else:
        model = ModelConfig(
            arch=args.arch,
            hash_levels=args.hash_levels,
            hash_table_log2=args.hash_table_log2,
            hash_base_res=args.hash_base_res,
            hash_max_res=args.hash_max_res,
            hash_aabb=args.hash_aabb,
            hash_brick=args.hash_brick,
            fac_levels=args.fac_levels,
            fac_base_res=args.fac_base_res,
            fac_max_res=args.fac_max_res,
            fac_comps=args.fac_comps,
            fac_aabb=args.fac_aabb,
            fac_l1=args.fac_l1,
            sigma_activation=args.sigma_activation,
            ipe=args.ipe,
            contract=args.contract,
        )
        render_cfg = RenderConfig(
            num_samples=args.num_samples,
            num_fine_samples=args.num_fine_samples,
            share_network=args.share_network,
            fine_mode=args.fine_mode,
            white_background=args.white_background,
            occ_res=args.occ_res,
            occ_update_steps=args.occ_update_steps,
            occ_threshold=args.occ_threshold,
            occ_aabb=args.occ_aabb,
            occ_bins=args.occ_bins,
            occ_decay=args.occ_decay,
            occ_uniform_frac=args.occ_uniform_frac,
            sampling_space=args.sampling_space,
        )
    return Config(
        debug=args.debug,
        do_train=args.do_train,
        eval_on_train=args.eval_on_train,
        live_preview=args.live_preview,
        log_densities_only=args.log_densities_only,
        log_dir=args.log_dir,
        save_dir=args.save_dir,
        load_path=args.load_path,
        run_name=args.run_name,
        camera=CameraConfig(
            width=args.width, height=args.height, near=args.near,
            far=args.far, ndc=args.ndc, ndc_near=args.ndc_near,
        ),
        model=model,
        render=render_cfg,
        train=TrainConfig(
            num_rays=args.num_rays,
            learning_rate=args.learning_rate,
            lr_decay_steps=args.lr_decay_steps,
            lr_final=args.lr_final,
            num_iter=args.num_iter,
            eval_steps=args.eval_steps,
            logging_steps=args.logging_steps,
            save_steps=args.save_steps,
            accumulation_steps=args.accumulation_steps,
            ema_decay=args.ema_decay,
            distortion_weight=args.distortion_weight,
            seed=args.seed,
            precision=args.precision,
            error_resample_frac=args.error_resample_frac,
            error_resample_ema=args.error_resample_ema,
            profile_steps=args.profile_steps,
        ),
        data=DataConfig(
            dataset=args.dataset,
            img_dir=args.img_dir,
            view_start=args.view_start,
            view_end=args.view_end,
            view_step=args.view_step,
            num_views_per_hemisphere=args.num_views_per_hemisphere,
            batch_mode=args.batch_mode,
            views_per_batch=args.views_per_batch,
            prefetch=args.prefetch,
            use_native_loader=args.use_native_loader,
            data_workers=args.data_workers,
            shard_pixel_store=args.shard_pixel_store,
            llff_factor=args.llff_factor,
            llff_holdout=args.llff_holdout,
            multiscale_levels=args.multiscale_levels,
            near_explicit="near" in getattr(args, "_explicit", set()),
            far_explicit="far" in getattr(args, "_explicit", set()),
        ),
        proposal=ProposalConfig(
            enabled=args.use_proposal,
            num_samples=args.proposal_samples,
            num_levels=args.proposal_levels,
            net_depth=args.proposal_depth,
            net_width=args.proposal_width,
            anneal_steps=args.proposal_anneal_steps,
        ),
        num_devices=args.num_devices,
    )


def cmd_train(args) -> int:
    cfg = config_from_args(args)
    scenes = [s for s in getattr(args, "scenes", "").split(",") if s]
    if scenes:
        from .train.loop import train_multiscene

        state = train_multiscene(cfg, scene_specs=scenes)
        print(f"done at step {int(state.step[0])} ({len(scenes)} scenes)")
        return 0
    from .train.loop import train

    state = train(cfg)
    print(f"done at step {int(state.step)}")
    return 0




def _scene_list(args):
    return [s for s in getattr(args, "scenes", "").split(",") if s]


def _restore_for_inference(args, cfg, mesh):
    """Init + weight-restore the TrainState for render/eval.

    With --scenes, the checkpoint is a STACKED multi-scene state
    (train_multiscene): restore into the stacked template and slice out
    --scene_index. Returns (state, loaded_path_or_None).
    """
    import jax

    from .train import checkpoint as ckpt
    from .train.step import init_state

    from .train.step import with_ema_params

    scenes = _scene_list(args)
    key = jax.random.PRNGKey(cfg.train.seed)
    load_path = cfg.load_path or ckpt.latest_checkpoint(cfg.save_dir)
    if not scenes:
        state = init_state(key, cfg)
        if load_path:
            state = ckpt.restore_weights(load_path, state)
        if state.ema is not None:
            print("using EMA weights for inference")
        return with_ema_params(state), load_path
    from .parallel import multiscene as ms_mod

    idx = getattr(args, "scene_index", 0)
    assert 0 <= idx < len(scenes), (idx, scenes)
    template = ms_mod.init_multiscene_state(key, cfg, len(scenes))
    if load_path:
        template = ckpt.restore_weights(load_path, template)
    state = ms_mod.scene_state(template, idx)
    if state.ema is not None:
        print("using EMA weights for inference")
    return with_ema_params(state), load_path


def cmd_render(args) -> int:
    import jax

    from .data.factory import make_dataset
    from .ops import rays as rays_ops, render as render_ops
    from .parallel import dp, mesh as mesh_mod
    from .train import checkpoint as ckpt
    from .train.loop import render_frame
    from .train.step import init_state
    from .data.images import save_png

    cfg = config_from_args(args)
    mesh = mesh_mod.make_mesh(cfg.num_devices)
    scenes = _scene_list(args)
    if scenes:
        from .train.loop import _scene_cfg

        dataset = make_dataset(
            _scene_cfg(cfg, scenes[args.scene_index]),
            sharding=mesh_mod.replicated_sharding(mesh),
        )
    else:
        dataset = make_dataset(cfg, sharding=mesh_mod.replicated_sharding(mesh))
    cfg = dataclasses.replace(cfg, camera=dataset.camera)

    # weight-only: inference must not depend on the training run's
    # optimizer hyperparameters (schedule changes the opt pytree)
    state, load_path = _restore_for_inference(args, cfg, mesh)
    if load_path:
        print(f"loaded {load_path} (step {int(state.step)})")
    else:
        print("warning: no checkpoint found; rendering an untrained field")
    state = dp.place_state(state, mesh)
    render_fn = dp.make_dp_render(cfg, mesh)

    os.makedirs(args.out_dir, exist_ok=True)
    t0 = time.time()
    def save_depth_acc(stem, depth, acc):
        # depth is the expected termination distance (ops/render.py):
        # normalize by far so the PNG is scale-free; acc is already
        # in [0, 1]. Grayscale as 3-channel for save_png.
        dn = np.clip(np.asarray(depth) / cfg.camera.far, 0.0, 1.0)
        save_png(stem + "-depth.png", np.repeat(dn[..., None], 3, -1))
        an = np.clip(np.asarray(acc), 0.0, 1.0)
        save_png(stem + "-acc.png", np.repeat(an[..., None], 3, -1))

    if args.view >= 0:
        o, d = dataset.view_rays(args.view)
        rgb, depth, acc = render_frame(cfg, state, o, d, mesh, render_fn)
        gold = dataset.view_gold(args.view)
        psnr = float(render_ops.psnr(rgb, gold))
        path = os.path.join(args.out_dir, f"view-{args.view}.png")
        save_png(path, np.asarray(rgb))
        if args.depth:
            save_depth_acc(os.path.join(args.out_dir,
                                        f"view-{args.view}"), depth, acc)
        print(f"{path}  psnr={psnr:.2f}  ({time.time()-t0:.2f}s)")
        return 0

    # 40-frame spherical sweep (BASELINE config 4): all frames' rays are
    # stacked into ONE sharded render call, one dispatch for the sweep
    path_angles = rays_ops.spherical_render_path(args.frames, args.pitch)
    import jax.numpy as jnp

    poses = rays_ops.pose_from_yaw_pitch(path_angles[:, 0], path_angles[:, 1])
    all_o, all_d = [], []
    for i in range(args.frames):
        o, d = rays_ops.maybe_ndc(
            *rays_ops.ray_grid(poses[i], cfg.camera), cfg.camera)
        all_o.append(o.reshape(-1, 3))
        all_d.append(d.reshape(-1, 3))
    h, w = cfg.camera.height, cfg.camera.width
    big_o = jnp.concatenate(all_o).reshape(args.frames * h, w, 3)
    big_d = jnp.concatenate(all_d).reshape(args.frames * h, w, 3)
    rgb, depth, acc = render_frame(cfg, state, big_o, big_d, mesh, render_fn)
    rgb = np.asarray(rgb).reshape(args.frames, h, w, 3)
    if args.depth:
        depth = np.asarray(depth).reshape(args.frames, h, w)
        acc = np.asarray(acc).reshape(args.frames, h, w)
    for i in range(args.frames):
        save_png(os.path.join(args.out_dir, f"frame-{i:03d}.png"), rgb[i])
        if args.depth:
            save_depth_acc(os.path.join(args.out_dir, f"frame-{i:03d}"),
                           depth[i], acc[i])
    if args.gif:
        try:
            import imageio

            frames_u8 = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
            gif_path = os.path.join(args.out_dir, "sweep.gif")
            imageio.mimsave(gif_path, list(frames_u8), fps=10, loop=0)
            print(f"wrote {gif_path}")
        except Exception as e:  # imageio is optional
            print(f"gif skipped: {e}")
    dt = time.time() - t0
    print(
        f"rendered {args.frames} frames of {w}x{h} "
        f"in {dt:.2f}s ({dt/args.frames:.3f}s/frame)"
    )
    return 0


def cmd_eval(args) -> int:
    """Held-out PSNR over a full split — the quality metric of record
    (BASELINE.md: test PSNR). Renders every view of the split with the
    deterministic sampler and reports per-view + mean PSNR."""
    import jax
    import numpy as np

    from .data.factory import make_dataset
    from .ops import render as render_ops
    from .parallel import dp, mesh as mesh_mod
    from .train import checkpoint as ckpt
    from .train.loop import render_frame
    from .train.step import init_state
    from .data.images import save_png

    cfg = config_from_args(args)
    mesh = mesh_mod.make_mesh(cfg.num_devices)
    scenes = _scene_list(args)
    if scenes:
        from .train.loop import _scene_cfg

        dataset = make_dataset(
            _scene_cfg(cfg, scenes[args.scene_index]), split=args.split,
            sharding=mesh_mod.replicated_sharding(mesh),
        )
    else:
        dataset = make_dataset(
            cfg, split=args.split, sharding=mesh_mod.replicated_sharding(mesh)
        )
    cfg = dataclasses.replace(cfg, camera=dataset.camera)
    state, load_path = _restore_for_inference(args, cfg, mesh)
    if not load_path:
        print("error: no checkpoint found (use --load_path or --save_dir)")
        return 1
    print(f"loaded {load_path} (step {int(state.step)})")
    state = dp.place_state(state, mesh)
    render_fn = dp.make_dp_render(cfg, mesh)

    from .ops.metrics import ssim as ssim_fn

    n = dataset.num_views if args.max_views <= 0 else min(args.max_views, dataset.num_views)
    scales = [int(s) for s in args.scales.split(",") if s] or [1]
    per_scale = {}  # scale -> (psnrs, ssims)
    t0 = time.time()
    for scale in scales:
        # each scale is its own compiled render program (static camera);
        # --ipe models widen their conical footprint by `scale` through
        # the scaled camera (data/device_dataset.scaled_camera)
        if scale == 1:
            scfg, sfn = cfg, render_fn
        else:
            scfg = dataclasses.replace(
                cfg, camera=dataset.scaled_camera(scale))
            sfn = dp.make_dp_render(scfg, mesh)
        psnrs, ssims = per_scale.setdefault(scale, ([], []))
        tag = f" 1/{scale}" if len(scales) > 1 else ""
        for v in range(n):
            o, d = dataset.view_rays(v, scale=scale)
            rgb, _, _ = render_frame(scfg, state, o, d, mesh, sfn)
            gold = dataset.view_gold(v, scale=scale)
            p = float(render_ops.psnr(rgb, gold))
            s = float(ssim_fn(rgb[..., :3], gold[..., :3]))
            psnrs.append(p)
            ssims.append(s)
            print(f"view {v:3d}{tag}: psnr {p:.2f}  ssim {s:.4f}")
            if args.out_dir:
                suffix = f"-s{scale}" if len(scales) > 1 else ""
                save_png(os.path.join(args.out_dir, f"eval-{v:03d}{suffix}.png"),
                         np.asarray(rgb))
    for scale in scales:
        psnrs, ssims = per_scale[scale]
        tag = f" at 1/{scale}" if len(scales) > 1 else ""
        print(
            f"mean psnr over {n} {args.split} views{tag}: {np.mean(psnrs):.2f} "
            f"(min {np.min(psnrs):.2f}, max {np.max(psnrs):.2f}), "
            f"mean ssim {np.mean(ssims):.4f} in {time.time()-t0:.1f}s"
        )
    if len(scales) > 1:
        allp = [p for ps, _ in per_scale.values() for p in ps]
        alls = [s for _, ss in per_scale.values() for s in ss]
        print(f"multiscale mean psnr: {np.mean(allp):.2f}, "
              f"mean ssim {np.mean(alls):.4f}")
    return 0


def cmd_export(args) -> int:
    """Export the trained field: sigma/RGB sampled on a grid_res^3 grid
    (.npz) plus a thresholded colored point cloud (.ply) for MeshLab/
    Blender/Open3D inspection. The reference has no export surface at
    all (its only field output is the live window, src/display.rs)."""
    from .parallel import mesh as mesh_mod
    from .utils import export as export_mod

    cfg = config_from_args(args)
    mesh = mesh_mod.make_mesh(cfg.num_devices)
    state, load_path = _restore_for_inference(args, cfg, mesh)
    if not load_path:
        print("error: no checkpoint found (use --load_path or --save_dir)")
        return 1
    print(f"loaded {load_path} (step {int(state.step)})")
    t0 = time.time()
    sigma, rgb = export_mod.sample_density_grid(
        state.params, cfg.model, res=args.grid_res, aabb=args.export_aabb,
    )
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    export_mod.save_npz(args.out + ".npz", sigma, rgb, args.export_aabb)
    xyz, rgb8 = export_mod.occupied_points(
        sigma, rgb, args.export_aabb, args.threshold
    )
    export_mod.save_ply(args.out + ".ply", xyz, rgb8)
    print(
        f"exported {args.grid_res}^3 grid -> {args.out}.npz, "
        f"{xyz.shape[0]} points (sigma > {args.threshold}) -> "
        f"{args.out}.ply in {time.time()-t0:.1f}s"
    )
    if args.mesh:
        from .utils import mesh as mesh_mod

        verts, faces, colors = mesh_mod.marching_tetrahedra(
            sigma, args.threshold, args.export_aabb, rgb=rgb
        )
        mesh_path = args.out + "_mesh.ply"
        mesh_mod.save_mesh_ply(mesh_path, verts, faces, colors)
        print(f"mesh: {verts.shape[0]} verts / {faces.shape[0]} faces "
              f"-> {mesh_path}")
    return 0


# the checkout's root: the package's parent directory
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compile_cache() -> str:
    """Persistent XLA compilation cache shared across processes, so a
    train -> eval -> render sequence compiles each program once.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX keeps its cache there
    and nothing is set here. Otherwise the cache goes to one fixed
    directory inside the checkout, ``<checkout>/.jax_cache`` (a path
    that moves between runs would never hit). Returns the directory.
    """
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(_CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # record which flags the user explicitly passed, so presets
    # (_apply_preset) never override them
    args._explicit = explicit_dests(
        sys.argv[1:] if argv is None else argv
    )
    enable_compile_cache()
    if getattr(args, "debug_nans", False):
        import jax

        jax.config.update("jax_debug_nans", True)
    if args.cmd == "train":
        return cmd_train(args)
    if args.cmd == "render":
        return cmd_render(args)
    if args.cmd == "eval":
        return cmd_eval(args)
    if args.cmd == "export":
        return cmd_export(args)
    return 1


if __name__ == "__main__":
    sys.exit(main())
