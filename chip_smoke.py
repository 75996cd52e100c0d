"""Proof that the NeRF trainer and renderer run on an NVIDIA GPU.

    python chip_smoke.py                # one card: phases 1-5 below
    python chip_smoke.py --four-cards   # four cards: the multi-card paths only
    python chip_smoke.py --out DIR      # checkpoints, logs, renders (runs/chip_smoke)

One process and one JAX client; every phase calls into the package
in-process, and nvidia-smi is the only child process. Each phase prints
one line of findings with its wall time.

  1 device      the devices JAX found, the card's name and power limit;
                exits non-zero at once unless the platform is "gpu"
  2 flagship    `train --preset full --dataset sphere` through cli.main
                (paper NeRF: PE L=10/4, 8x256 trunk + skip + view head,
                64 samples, 4096-ray batches, mixed precision), then
                `eval` and an 800x800 `render` from the checkpoint; the
                train step's compile time and steady step time
  3 reference   the shipped bf16 path against a plain float32 reference
                on one batch, at the trained and the initial weights:
                loss, gradients, the 800x800 frame
  4 presets     every other trained preset: three train steps each, and
                one step's loss against the float32 reference
  5 memory      memory_analysis() of the train step and of one render
                chunk, and the device's peak bytes in use

The last line of a passing run is exactly
  {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}
A failed phase does not stop the later ones; the run then exits
non-zero without that line.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import sys
import time
import traceback
from typing import Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from nerf_rs_tpu import cli
from nerf_rs_tpu.data.factory import make_dataset
from nerf_rs_tpu.data.images import decode_png
from nerf_rs_tpu.ops import rays as rays_ops
from nerf_rs_tpu.parallel import dp, mesh as mesh_mod
from nerf_rs_tpu.parallel import multiscene as ms_mod
from nerf_rs_tpu.train import checkpoint as ckpt
from nerf_rs_tpu.train import step as step_mod
from nerf_rs_tpu.train.loop import render_frame
from nerf_rs_tpu.utils.gpu import card_lines, require_gpu

# Tolerances of the shipped path against the float32 reference. The
# trunk runs in bf16, which keeps 8 mantissa bits (relative rounding
# ~4e-3), and the error compounds through the 9 matmuls of the trunk
# and view head, so a loss agrees to about a percent and a composited
# colour to a few hundredths; a wrong formula or a dropped term misses
# both by far more. Gradients are compared by direction per leaf, at
# the initial weights: the first trunk layer's gradient passes back
# through all eight bf16 layers and lands lowest (cosine 0.99987 at
# 4096 rays on the H100, 0.989 at 64 rays on the CPU). At trained
# weights the gradient is a cancellation over the batch, and bf16 noise
# is a large and varying part of it (whole-gradient cosine 0.97-0.99
# over three runs on the H100), so there only the loss and the frame
# are held to bounds and the cosines are reported.
LOSS_RTOL = 2e-2
GRAD_MIN_COS = 0.98
FRAME_ATOL = 3e-2
# A frame is held to the share of pixels beyond FRAME_ATOL and to its
# mean error, not to one maximum. bf16 rounding of the density passes
# through the compositing exponential, so where a ray's opacity turns
# fast a pixel moves far: at the trained sphere's rim, pixels flip
# between background and disk (measured on the H100: 0.45% of the
# 800x800 frame, up to 0.99), and even the untrained field has pixels
# off by 0.09 (0.32% beyond FRAME_ATOL). 2% of 800x800 is a band ~10
# pixels wide along the disk's 1257-pixel rim; a wrong formula moves
# most pixels.
FRAME_OFF_SHARE = 2e-2
FRAME_MEAN_ATOL = 1e-2
# A leaf whose gradient is a cancellation, such as the density bias
# summed over every sample of the batch, has a direction set by
# rounding. It also passes when it differs from the reference by less
# than this share of the whole gradient's norm.
GRAD_SHARE_ATOL = 1e-3
# float32 with XLA's default matmul precision against float32 at
# "highest": on the GPU the former may use TF32 (10 mantissa bits,
# ~1e-3 per product), so this bound shows whether it does where the
# code meant full precision.
F32_LOSS_RTOL = 1e-3
# one card against four on the same global batch, both in float32 at
# "highest": only the order of the gradient reduction differs. Adam's
# first step is lr * sign(g), so the rare element whose gradient is at
# rounding level can flip; the bound is on the whole update's norm.
DP_LOSS_RTOL = 1e-4
DP_UPDATE_RTOL = 1e-2
# A sharded frame against the one-card frame. In float32 at "highest"
# the two programs agree bit for bit (measured on four H100s), so that
# strict check is what a wrong shard order or gather fails. In bf16
# they are separate compilations whose rounding differs, amplified as
# in FRAME_OFF_SHARE; how many pixels pass 3e-2 then depends on how
# steep the field is (four cards against one, after two DP steps: 6.3%
# of pixels, mean 0.0071), so the bf16 frames are held to the mean
# bound only.
SHARD_F32_ATOL = 1e-3
SHARD_F32_OFF_SHARE = 1e-3

PRESETS = ("hierarchical", "mipnerf", "record", "unbounded", "proposal",
           "factored", "ngp")


@dataclasses.dataclass(frozen=True)
class Scale:
    """How big a run is. FULL is what the card runs; the tests pass a
    tiny one so that every phase also runs on the CPU."""

    train_steps: int = 300     # flagship CLI iterations
    num_rays: int = 4096
    num_samples: int = 64
    train_hw: int = 128        # sphere views the trainer sees
    render_hw: int = 800       # the rendered frame
    preset_steps: int = 3
    time_steps: int = 50       # steady-state timing window
    dp_steps: int = 2          # --four-cards: steps compared with one card
    store_steps: int = 30      # --four-cards: sharded-store training steps
    # quality the flagship must reach: train PSNR after train_steps
    # (the sphere recipe clears 17 dB by step 300) and the disk in the
    # rendered frame. None skips the check (too few steps to learn).
    min_psnr: Optional[float] = 17.0
    check_disk: bool = True
    # applied to every Config the phases build directly (presets,
    # reference, four-card paths): identity at full width
    adapt: Callable = staticmethod(lambda cfg: cfg)


FULL = Scale()


class PhaseFailed(Exception):
    pass


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseFailed(what)


def cli_config(argv: List[str]):
    """The Config a `python -m nerf_rs_tpu.cli <argv>` run resolves."""
    args = cli.build_parser().parse_args(argv)
    args._explicit = cli.explicit_dests(argv)
    return cli.config_from_args(args)


def _with_precision(cfg, precision: str):
    return dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, precision=precision))


def _cos(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0.0 and nb == 0.0:
        return 1.0
    if na == 0.0 or nb == 0.0:
        return 0.0
    return float(a @ b / (na * nb))


def _loss_and_grads(cfg, trainable, batch, key, grid, step, grads: bool):
    f = (jax.value_and_grad(step_mod.loss_fn, has_aux=True) if grads
         else step_mod.loss_fn)
    out = jax.jit(lambda t, b, k, g, s: f(t, b, k, cfg, g, s))(
        trainable, batch, key, grid, step)
    if grads:
        (loss, _), g = out
        return float(loss), jax.device_get(g)
    loss, _ = out
    return float(loss), None


def reference_gap(cfg, trainable, batch, key, grid=None, step=None,
                  grads: bool = True) -> Dict:
    """The shipped loss (and gradients) of ``cfg`` against the plain
    float32 reference: the same loss_fn with precision="f32" under
    jax.default_matmul_precision("highest"), on the same batch and key.
    Also float32 at XLA's default precision, for the TF32 check."""
    loss, g = _loss_and_grads(cfg, trainable, batch, key, grid, step, grads)
    f32 = _with_precision(cfg, "f32")
    loss_f32, _ = _loss_and_grads(f32, trainable, batch, key, grid, step,
                                  False)
    with jax.default_matmul_precision("highest"):
        loss_ref, g_ref = _loss_and_grads(f32, trainable, batch, key, grid,
                                          step, grads)
    out = {
        "loss": loss, "loss_ref": loss_ref,
        "loss_rel": abs(loss - loss_ref) / max(abs(loss_ref), 1e-12),
        "f32_loss_rel": abs(loss_f32 - loss_ref) / max(abs(loss_ref), 1e-12),
    }
    if grads:
        ref = jax.tree_util.tree_leaves(g_ref)
        total = math.sqrt(sum(float(np.sum(np.square(r, dtype=np.float64)))
                              for r in ref))
        out["grad_cos"] = _cos(
            np.concatenate([np.ravel(a) for a in jax.tree_util.tree_leaves(g)]),
            np.concatenate([np.ravel(r) for r in ref]))
        cos, off = {}, {}
        for (p, a), r in zip(jax.tree_util.tree_leaves_with_path(g), ref):
            name = jax.tree_util.keystr(p)
            cos[name] = _cos(a, r)
            share = float(np.linalg.norm(np.asarray(a, np.float64)
                                         - np.asarray(r, np.float64)))
            share /= max(total, 1e-30)
            if cos[name] < GRAD_MIN_COS and share > GRAD_SHARE_ATOL:
                off[name] = {"cos": cos[name], "share": share}
        worst = min(cos, key=cos.get)
        out.update(min_grad_cos=cos[worst], min_grad_cos_leaf=worst,
                   grad_leaves_off=off)
    return out


def _check_gap(gap: Dict, name: str, grads: bool = True) -> None:
    _check(math.isfinite(gap["loss"]) and math.isfinite(gap["loss_ref"]),
           f"{name}: non-finite loss {gap['loss']} / {gap['loss_ref']}")
    _check(gap["loss_rel"] <= LOSS_RTOL,
           f"{name}: loss differs from the f32 reference by "
           f"{gap['loss_rel']:.3g} > {LOSS_RTOL}")
    _check(gap["f32_loss_rel"] <= F32_LOSS_RTOL,
           f"{name}: f32 at default precision differs from highest by "
           f"{gap['f32_loss_rel']:.3g} > {F32_LOSS_RTOL} (TF32 is on)")
    if grads and gap.get("grad_leaves_off"):
        _check(False, f"{name}: gradients off the f32 reference (cosine < "
                      f"{GRAD_MIN_COS} and difference > {GRAD_SHARE_ATOL} "
                      f"of the gradient's norm): {gap['grad_leaves_off']}")


def _memory(compiled) -> Dict[str, int]:
    m = compiled.memory_analysis()
    if m is None:
        return {}
    return {k: int(getattr(m, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes",
        "generated_code_size_in_bytes") if hasattr(m, k)}


# ---------------------------------------------------------------- phases


def phase_device(platform: Optional[str] = None,
                 cards: Optional[List[str]] = None) -> Dict:
    """Refuse anything but a GPU; name the devices and the card."""
    devs = jax.devices()
    platform = devs[0].platform if platform is None else platform
    require_gpu("chip_smoke.py", platform)
    cards = card_lines() if cards is None else cards
    for line in cards:
        print(f"card: {line}", flush=True)
    return {
        "devices": [str(d) for d in devs], "platform": platform,
        "kind": devs[0].device_kind, "count": len(devs), "card": cards,
        "jax": jax.__version__, "XLA_FLAGS": os.environ.get("XLA_FLAGS", ""),
    }


def flagship_argv(cmd: str, run: str, scale: Scale) -> List[str]:
    hw = scale.render_hw if cmd == "render" else scale.train_hw
    return [cmd, "--preset", "full", "--dataset", "sphere",
            "--num_rays", str(scale.num_rays),
            "--num_samples", str(scale.num_samples),
            "--width", str(hw), "--height", str(hw),
            "--save_dir", os.path.join(run, "ckpt"),
            "--log_dir", os.path.join(run, "logs"), "--seed", "0"]


def _run_cli(argv: List[str], log_path: str) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    with open(log_path, "a") as f:
        f.write(f"$ nerf_rs_tpu.cli {' '.join(argv)}\n{buf.getvalue()}")
    _check(rc == 0, f"cli {argv[0]} exited {rc}; see {log_path}")
    return buf.getvalue()


def _last(pattern: str, text: str, what: str) -> float:
    found = re.findall(pattern, text)
    _check(bool(found), f"the CLI printed no {what}")
    return float(found[-1])


def phase_flagship(run: str, scale: Scale, ctx: Dict) -> Dict:
    """Train, eval and render the flagship through cli.main; then time
    the same train step (compile and steady state)."""
    shutil.rmtree(run, ignore_errors=True)
    os.makedirs(run)
    log = os.path.join(run, "cli.log")
    n = scale.train_steps
    t0 = time.perf_counter()
    out = _run_cli(flagship_argv("train", run, scale) + [
        "--num_iter", str(n + 1), "--eval_steps", str(n),
        "--logging_steps", str(n), "--save_steps", str(10 * n + 1)], log)
    train_s = time.perf_counter() - t0
    loss = _last(rf"iter={n}, loss=(\S+)", out, "train loss")
    _check(math.isfinite(loss), f"train loss {loss}")
    train_psnr = -10.0 * math.log10(max(loss, 1e-12))
    eval_psnr = _last(rf"iter={n}, eval psnr=(\S+)", out, "eval PSNR")
    if scale.min_psnr is not None:
        _check(train_psnr > scale.min_psnr,
               f"train PSNR {train_psnr:.2f} <= {scale.min_psnr} at step {n}")

    t0 = time.perf_counter()
    out = _run_cli(flagship_argv("eval", run, scale) + ["--max_views", "4"],
                   log)
    eval_s = time.perf_counter() - t0
    mean_psnr = _last(r"mean psnr over \d+ \S+ views: (\S+)", out,
                      "eval mean PSNR")
    _check(math.isfinite(mean_psnr), f"eval mean PSNR {mean_psnr}")

    t0 = time.perf_counter()
    frames = os.path.join(run, "render")
    out = _run_cli(flagship_argv("render", run, scale) + [
        "--view", "0", "--out_dir", frames], log)
    render_s = time.perf_counter() - t0
    render_psnr = _last(r"view-0\.png\s+psnr=(\S+)", out, "render PSNR")
    with open(os.path.join(frames, "view-0.png"), "rb") as f:
        img = decode_png(f.read()).astype(np.float32) / 255.0
    hw = scale.render_hw
    _check(img.shape[:2] == (hw, hw), f"frame shape {img.shape}")
    c = hw // 2
    r = max(hw // 16, 1)
    centre = float(img[c - r:c + r, c - r:c + r, :3].mean())
    corner = float(img[:2 * r, :2 * r, :3].mean())
    if scale.check_disk:
        _check(centre > 0.9 and corner < 0.1,
               f"frame shows no disk: centre {centre:.3f}, corner "
               f"{corner:.3f}")

    # the same train step the CLI ran: compile time, steady step time
    cfg = cli_config(flagship_argv("train", run, scale))
    mesh = mesh_mod.make_mesh(1)
    ds = make_dataset(cfg, sharding=mesh_mod.replicated_sharding(mesh))
    key = jax.random.PRNGKey(0)
    state = dp.place_state(step_mod.init_state(key, cfg), mesh)
    step_fn = dp.make_dp_train_step(cfg, mesh, dataset=ds)
    t0 = time.perf_counter()
    compiled = step_fn.lower(state, ds.images, ds.pose_data, key).compile()
    compile_s = time.perf_counter() - t0
    state, aux = compiled(state, ds.images, ds.pose_data, key)
    jax.block_until_ready((state, aux))
    t0 = time.perf_counter()
    for i in range(scale.time_steps):
        state, aux = compiled(state, ds.images, ds.pose_data,
                              jax.random.fold_in(key, i))
    jax.block_until_ready((state, aux))
    step_ms = 1e3 * (time.perf_counter() - t0) / scale.time_steps
    ctx.update(run=run, cfg=cfg, step_compiled=compiled)
    return {
        "train_s": train_s, "eval_s": eval_s, "render_s": render_s,
        "loss": loss, "train_psnr": train_psnr, "eval_psnr_view0": eval_psnr,
        "eval_mean_psnr": mean_psnr, "render_psnr": render_psnr,
        "frame_centre": centre, "frame_corner": corner,
        "step_compile_s": compile_s, "step_ms": step_ms,
        "ray_samples_per_s": scale.num_rays * scale.num_samples
        / (step_ms / 1e3),
        "tolerances": {"min_train_psnr": scale.min_psnr,
                       "disk": "centre > 0.9, corner < 0.1"
                       if scale.check_disk else None},
    }


def _trained_state(cfg, run: str):
    template = step_mod.init_state(jax.random.PRNGKey(0), cfg)
    path = ckpt.latest_checkpoint(os.path.join(run, "ckpt"))
    _check(path is not None, f"no checkpoint under {run}/ckpt")
    return ckpt.restore_weights(path, template)


def _frame(cfg, state, hw: int, mesh):
    """hw x hw frame of the sphere scene's first view (the view
    `render --view 0` draws)."""
    cam = dataclasses.replace(cfg.camera, width=hw, height=hw)
    rcfg = dataclasses.replace(cfg, camera=cam)
    a = rays_ops.view_angle_grid(cfg.data.num_views_per_hemisphere)[0]
    pose = rays_ops.pose_from_yaw_pitch(a[0], a[1])
    o, d = rays_ops.maybe_ndc(*rays_ops.ray_grid(pose, cam), cam)
    rgb, _, _ = render_frame(rcfg, state, o, d, mesh,
                             dp.make_dp_render(rcfg, mesh))
    return np.asarray(jax.device_get(rgb))


def _frame_diff(a, b, atol: float) -> Dict:
    diff = np.abs(a - b).max(-1)
    return {"finite": bool(np.isfinite(a).all()),
            "max_abs": float(diff.max()), "mean_abs": float(diff.mean()),
            "off_share": float((diff > atol).mean())}


def _frame_gap(cfg, state, hw: int, mesh) -> Dict:
    rgb = _frame(cfg, state, hw, mesh)
    with jax.default_matmul_precision("highest"):
        rgb_ref = _frame(_with_precision(cfg, "f32"), state, hw, mesh)
    return _frame_diff(rgb, rgb_ref, FRAME_ATOL)


def phase_reference(scale: Scale, ctx: Dict) -> Dict:
    """The flagship's loss, gradients and rendered frame, at the trained
    and at the initial weights, against the plain float32 reference."""
    cfg = ctx["cfg"]
    trained = _trained_state(cfg, ctx["run"])
    init = step_mod.init_state(jax.random.PRNGKey(0), cfg)
    mesh = mesh_mod.make_mesh(1)
    ds = make_dataset(cfg, sharding=mesh_mod.replicated_sharding(mesh))
    key = jax.random.PRNGKey(1)
    batch = ds.sample_batch(jax.random.fold_in(key, 0), scale.num_rays)
    gap = {}
    for name, state in (("trained", trained), ("init", init)):
        gap[name] = reference_gap(
            cfg, step_mod._trainable(state, cfg), batch,
            jax.random.fold_in(key, 1), state.grid, state.step)
        gap[f"frame_{name}"] = _frame_gap(cfg, state, scale.render_hw, mesh)
    gap["tolerances"] = {
        "loss_rtol": LOSS_RTOL, "grad_min_cos": GRAD_MIN_COS,
        "grad_share_atol": GRAD_SHARE_ATOL,
        "frame_atol": FRAME_ATOL, "frame_off_share": FRAME_OFF_SHARE,
        "frame_mean_atol": FRAME_MEAN_ATOL, "f32_loss_rtol": F32_LOSS_RTOL}
    try:
        _check_gap(gap["init"], "flagship at init")
        _check_gap(gap["trained"], "flagship trained", grads=False)
        for name in ("trained", "init"):
            f = gap[f"frame_{name}"]
            _check(f["finite"], f"non-finite pixels in the {name} frame")
            _check(f["off_share"] <= FRAME_OFF_SHARE
                   and f["mean_abs"] <= FRAME_MEAN_ATOL,
                   f"{name} frame: {f['off_share']:.4f} of pixels off by "
                   f"> {FRAME_ATOL} (bound {FRAME_OFF_SHARE}), mean "
                   f"{f['mean_abs']:.4f} (bound {FRAME_MEAN_ATOL})")
    except PhaseFailed as e:
        raise PhaseFailed(f"{e} | {json.dumps(gap)}") from None
    return gap


def preset_config(preset: str, scale: Scale):
    return scale.adapt(cli_config(["train", "--preset", preset,
                                   "--dataset", "sphere"]))


def phase_presets(scale: Scale, presets=PRESETS) -> Dict:
    """Each trained preset: a few steps through make_dp_train_step (the
    CLI's step) with finite losses, and one step's loss against the
    float32 reference."""
    mesh = mesh_mod.make_mesh(1)
    found, failed = {}, []
    for name in presets:
        t0 = time.perf_counter()
        cfg = preset_config(name, scale)
        ds = make_dataset(cfg, sharding=mesh_mod.replicated_sharding(mesh))
        key = jax.random.PRNGKey(0)
        state = dp.place_state(step_mod.init_state(key, cfg), mesh)
        step_fn = dp.make_dp_train_step(cfg, mesh, dataset=ds)
        losses = []
        for i in range(scale.preset_steps):
            state, aux = step_fn(state, ds.train_store, ds.pose_data,
                                 jax.random.fold_in(key, i))
            losses.append(float(aux["loss"]))
        batch = ds.sample_batch(jax.random.PRNGKey(7), cfg.train.num_rays)
        gap = reference_gap(cfg, step_mod._trainable(state, cfg), batch,
                            jax.random.PRNGKey(8), state.grid, state.step,
                            grads=False)
        gap["losses"] = losses
        gap["s"] = time.perf_counter() - t0
        found[name] = gap
        try:
            _check(all(math.isfinite(v) for v in losses),
                   f"{name}: non-finite train loss {losses}")
            _check_gap(gap, name)
        except PhaseFailed as e:
            failed.append(str(e))
    found["tolerances"] = {"loss_rtol": LOSS_RTOL,
                           "f32_loss_rtol": F32_LOSS_RTOL}
    if failed:
        raise PhaseFailed("; ".join(failed) + f" | {json.dumps(found)}")
    return found


def phase_memory(scale: Scale, ctx: Dict) -> Dict:
    """memory_analysis() of the flagship train step and of one render
    chunk at render_hw, and the device's peak bytes in use."""
    cfg = ctx["cfg"]
    mesh = mesh_mod.make_mesh(1)
    state = dp.place_state(step_mod.init_state(jax.random.PRNGKey(0), cfg),
                           mesh)
    chunk = dp.default_render_chunk(cfg.render, model_cfg=cfg.model)
    rays = min(chunk, scale.render_hw * scale.render_hw)
    o = jnp.zeros((rays, 3), jnp.float32)
    d = jnp.ones((rays, 3), jnp.float32)
    render_fn = dp.make_dp_render(cfg, mesh, chunk=chunk)
    compiled = render_fn.lower(state.params, state.params, o, d,
                               jax.random.PRNGKey(0)).compile()
    stats = jax.devices()[0].memory_stats() or {}
    return {
        "train_step": _memory(ctx["step_compiled"]),
        "render_chunk": {"rays": rays, **_memory(compiled)},
        "peak_bytes_in_use": stats.get("peak_bytes_in_use",
                                       "not reported by this platform"),
    }


# ------------------------------------------------------------ four cards


def _update_gap(p0, pa, pb) -> float:
    """||(pa - p0) - (pb - p0)|| / ||pb - p0|| over every leaf."""
    num = den = 0.0
    for a, b, z in zip(*(jax.tree_util.tree_leaves(jax.device_get(t))
                         for t in (pa, pb, p0))):
        ua = np.asarray(a, np.float64) - np.asarray(z, np.float64)
        ub = np.asarray(b, np.float64) - np.asarray(z, np.float64)
        num += float(((ua - ub) ** 2).sum())
        den += float((ub ** 2).sum())
    return math.sqrt(num / max(den, 1e-30))


def _replicated(tree, mesh_devices: int) -> bool:
    for leaf in jax.tree_util.tree_leaves(tree):
        shards = [np.asarray(s.data) for s in leaf.addressable_shards]
        if len(shards) != mesh_devices:
            return False
        if any(not np.array_equal(shards[0], s) for s in shards[1:]):
            return False
    return True


def _exact_cfg(scale: Scale):
    """The flagship in float32, deterministic sampling: one card and
    four then differ only in the order of the reductions."""
    cfg = scale.adapt(cli_config(flagship_argv("train", "", scale)))
    return dataclasses.replace(
        _with_precision(cfg, "f32"),
        render=dataclasses.replace(cfg.render, randomized=False))


def _dp_steps(cfg, mesh, state_host, batches, key):
    state = dp.place_state(state_host, mesh)
    step_fn = dp.make_dp_train_step(cfg, mesh)
    losses = []
    for i, b in enumerate(batches):
        state, aux = step_fn(state, dp.place_batch(b, mesh),
                             jax.random.fold_in(key, i))
        losses.append(float(aux["loss"]))
    return state, losses


def _batches(cfg, n: int, scale: Scale, mesh, seed: int = 0):
    ds = make_dataset(cfg, sharding=mesh_mod.replicated_sharding(mesh))
    key = jax.random.PRNGKey(100 + seed)
    return [jax.device_get(ds.sample_batch(jax.random.fold_in(key, i),
                                           scale.num_rays))
            for i in range(n)]


def phase_four_dp(devices, scale: Scale, ctx: Dict) -> Dict:
    """Data-parallel training on four cards against one card, on the
    same global batches: loss of every step, and the parameters."""
    cfg = _exact_cfg(scale)
    one = mesh_mod.make_mesh(1, devices=devices)
    four = mesh_mod.make_mesh(4, devices=devices)
    state0 = jax.device_get(step_mod.init_state(jax.random.PRNGKey(0), cfg))
    batches = _batches(cfg, scale.dp_steps, scale, one)
    key = jax.random.PRNGKey(3)
    with jax.default_matmul_precision("highest"):
        s1, l1 = _dp_steps(cfg, one, state0, batches, key)
        s4, l4 = _dp_steps(cfg, four, state0, batches, key)
    loss_rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(l4, l1))
    upd = _update_gap(state0.params, s4.params, s1.params)
    _check(_replicated(s4.params, 4), "parameters differ between cards")
    _check(loss_rel <= DP_LOSS_RTOL,
           f"4-card loss {l4} vs 1-card {l1}: {loss_rel:.3g} > {DP_LOSS_RTOL}")
    _check(upd <= DP_UPDATE_RTOL,
           f"4-card update differs by {upd:.3g} > {DP_UPDATE_RTOL}")
    ctx["dp_params"] = jax.device_get(s1)
    return {"losses_4": l4, "losses_1": l1, "loss_rel": loss_rel,
            "update_rel": upd, "tolerances": {"loss_rtol": DP_LOSS_RTOL,
                                              "update_rtol": DP_UPDATE_RTOL}}


def phase_four_render(devices, scale: Scale, ctx: Dict) -> Dict:
    """The sharded full-frame render (make_dp_render on four cards)
    against the one-card frame: in float32 at "highest", and in the
    shipped precision (each bf16 frame also against its f32 twin)."""
    cfg = scale.adapt(cli_config(flagship_argv("train", "", scale)))
    # the weights phase_four_dp trained, else a fresh init
    state = ctx.get("dp_params")
    if state is None:
        state = jax.device_get(step_mod.init_state(jax.random.PRNGKey(0), cfg))
    one = mesh_mod.make_mesh(1, devices=devices)
    four = mesh_mod.make_mesh(4, devices=devices)

    def frames(c):
        return (_frame(c, dp.place_state(state, one), scale.render_hw, one),
                _frame(c, dp.place_state(state, four), scale.render_hw, four))

    with jax.default_matmul_precision("highest"):
        f1, f4 = frames(_with_precision(cfg, "f32"))
    b1, b4 = frames(cfg)
    found = {
        "frame": list(b4.shape),
        "f32_4_vs_1": _frame_diff(f4, f1, SHARD_F32_ATOL),
        "bf16_4_vs_1": _frame_diff(b4, b1, FRAME_ATOL),
        "bf16_vs_f32_1": _frame_diff(b1, f1, FRAME_ATOL),
        "bf16_vs_f32_4": _frame_diff(b4, f4, FRAME_ATOL),
        "tolerances": {"f32_atol": SHARD_F32_ATOL,
                       "f32_off_share": SHARD_F32_OFF_SHARE,
                       "bf16_mean_atol": FRAME_MEAN_ATOL}}
    strict = found["f32_4_vs_1"]
    bf16 = [found[k] for k in ("bf16_4_vs_1", "bf16_vs_f32_1",
                               "bf16_vs_f32_4")]
    _check(strict["finite"] and strict["off_share"] <= SHARD_F32_OFF_SHARE
           and all(f["finite"] and f["mean_abs"] <= FRAME_MEAN_ATOL
                   for f in bf16),
           f"sharded frame differs from one card's: {json.dumps(found)}")
    return found


def phase_four_store(devices, scale: Scale) -> Dict:
    """--shard_pixel_store: each card holds a quarter of the views and
    samples its rays locally. Against the replicated store on one card
    trained for as many steps: both descend, to comparable losses."""
    argv = flagship_argv("train", "", scale) + ["--shard_pixel_store", "true"]
    cfg = scale.adapt(cli_config(argv))
    _check(cfg.data.shard_pixel_store, "the flag did not reach the config")
    out = {}
    for n, store in ((4, "sharded"), (1, "replicated")):
        mesh = mesh_mod.make_mesh(n, devices=devices)
        sharding = (mesh_mod.view_sharding(mesh) if n > 1
                    else mesh_mod.replicated_sharding(mesh))
        ds = make_dataset(cfg, sharding=sharding)
        if n > 1:
            views = {s.data.shape[0] for s in ds.images.addressable_shards}
            _check(views == {ds.images.shape[0] // n},
                   f"store not split by view: {views}")
        key = jax.random.PRNGKey(0)
        state = dp.place_state(step_mod.init_state(key, cfg), mesh)
        step_fn = dp.make_dp_train_step(cfg, mesh, dataset=ds,
                                        shard_store=n > 1)
        losses = []
        for i in range(scale.store_steps):
            state, aux = step_fn(state, ds.images, ds.pose_data,
                                 jax.random.fold_in(key, i))
            losses.append(float(aux["loss"]))
        _check(all(math.isfinite(v) for v in losses),
               f"{store} store: non-finite loss {losses}")
        if n > 1:
            _check(_replicated(state.params, n),
                   "parameters differ between cards")
        out[store] = {"first": losses[0], "last": losses[-1]}
    s, r = out["sharded"], out["replicated"]
    _check(s["last"] < s["first"], f"sharded store did not descend: {s}")
    _check(s["last"] < 2.0 * r["last"] + 1e-3,
           f"sharded store ends at {s['last']:.4g}, replicated at "
           f"{r['last']:.4g}")
    return out


def phase_four_scenes(devices, scale: Scale) -> Dict:
    """Two scenes on a 2x2 (scene, data) mesh against each scene
    trained alone on one card, on the same batches."""
    cfg = _exact_cfg(scale)
    n_scenes = 2
    mesh2 = mesh_mod.make_scene_mesh(n_scenes, 4, devices=devices)
    _check(dict(mesh2.shape) == {"scene": 2, "data": 2},
           f"mesh {dict(mesh2.shape)}")
    one = mesh_mod.make_mesh(1, devices=devices)
    ms0 = jax.device_get(
        ms_mod.init_multiscene_state(jax.random.PRNGKey(4), cfg, n_scenes))
    per_scene = [_batches(cfg, scale.dp_steps, scale, one, seed=s)
                 for s in range(n_scenes)]
    key = jax.random.PRNGKey(5)
    from jax.sharding import NamedSharding, PartitionSpec as P

    with jax.default_matmul_precision("highest"):
        step_fn = ms_mod.make_multiscene_train_step(cfg, mesh2, n_scenes)
        ms = jax.device_put(ms0, NamedSharding(mesh2, P(mesh_mod.SCENE_AXIS)))
        bs = NamedSharding(mesh2, P(mesh_mod.SCENE_AXIS, mesh_mod.DATA_AXIS))
        ms_losses = []
        for i in range(scale.dp_steps):
            b = ms_mod.stack_batches([per_scene[s][i]
                                      for s in range(n_scenes)])
            ms, aux = step_fn(ms, jax.device_put(b, bs),
                              jax.random.fold_in(key, i))
            ms_losses.append(np.asarray(jax.device_get(aux["loss"])))
        ms = jax.device_get(ms)
        out = {}
        for s in range(n_scenes):
            s1, l1 = _dp_steps(cfg, one, ms_mod.scene_state(ms0, s),
                               per_scene[s], key)
            l2 = [float(x[s]) for x in ms_losses]
            rel = max(abs(a - b) / max(abs(b), 1e-12)
                      for a, b in zip(l2, l1))
            upd = _update_gap(ms_mod.scene_state(ms0, s).params,
                              ms_mod.scene_state(ms, s).params, s1.params)
            _check(rel <= DP_LOSS_RTOL,
                   f"scene {s}: 2x2 loss {l2} vs 1-card {l1}")
            _check(upd <= DP_UPDATE_RTOL,
                   f"scene {s}: update differs by {upd:.3g}")
            out[f"scene_{s}"] = {"losses_2x2": l2, "losses_1": l1,
                                 "loss_rel": rel, "update_rel": upd}
    return out


# ------------------------------------------------------------------ main


def _phase(name: str, fn, failures: List[str]):
    t0 = time.perf_counter()
    try:
        found = fn()
    except Exception as e:  # report, and go on to the next phase
        dt = time.perf_counter() - t0
        traceback.print_exc()
        print(f"phase {name}: FAILED in {dt:.1f} s: {e}", flush=True)
        failures.append(name)
        return None
    dt = time.perf_counter() - t0
    print(f"phase {name}: ok in {dt:.1f} s: {json.dumps(found, default=str)}",
          flush=True)
    return found


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the multi-card paths, each against "
                        "one card (needs four GPUs)")
    p.add_argument("--out", default=os.path.join("runs", "chip_smoke"),
                   help="directory for checkpoints, logs and renders")
    args = p.parse_args(argv)
    cache = cli.enable_compile_cache()

    t0 = time.perf_counter()
    dev = phase_device()
    dev["compile_cache"] = cache
    print(f"phase device: ok in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps(dev)}", flush=True)
    failures: List[str] = []
    ctx: Dict = {}
    scale = FULL
    if args.four_cards:
        devices = jax.devices()
        if len(devices) < 4:
            raise SystemExit(f"--four-cards needs 4 GPUs, JAX found "
                             f"{len(devices)}")
        devices = devices[:4]
        _phase("four_dp", lambda: phase_four_dp(devices, scale, ctx),
               failures)
        _phase("four_render", lambda: phase_four_render(devices, scale, ctx),
               failures)
        _phase("four_store", lambda: phase_four_store(devices, scale),
               failures)
        _phase("four_scenes", lambda: phase_four_scenes(devices, scale),
               failures)
    else:
        run = os.path.join(args.out, "flagship")
        _phase("flagship", lambda: phase_flagship(run, scale, ctx), failures)
        _phase("reference", lambda: phase_reference(scale, ctx), failures)
        _phase("presets", lambda: phase_presets(scale), failures)
        _phase("memory", lambda: phase_memory(scale, ctx), failures)
    if failures:
        print(f"chip_smoke: {len(failures)} phase(s) failed: "
              f"{', '.join(failures)}", flush=True)
        return 1
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
