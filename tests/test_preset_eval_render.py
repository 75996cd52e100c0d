"""Every preset's eval/render path must RUN under its CLI-resolved config.

Round-5 regression: a routing bug — dp.make_dp_render treated the
second-net slot as a radiance net unconditionally, but under
--preset unbounded that slot carries the PROPOSAL MLP (density-only
tree, no feature/view/rgb heads), so the first mid-train eval render of
every proposal-family CLI run died with KeyError('feature') after the
full training budget was spent (runs/deep_* , 30k-iter arms lost at
iter 5000).  test_bench_cli_seam.py pins the resolved FLAGS; this test
goes one step further and actually renders a tiny frame for every
preset exactly the way train/loop.py's eval hook does, so a config
combination whose render path crashes fails CI before it can burn a
30k-iteration run on the card.
"""

import dataclasses

import jax
import numpy as np
import pytest

from nerf_rs_tpu.cli import build_parser, config_from_args, explicit_dests
from nerf_rs_tpu.ops import rays
from nerf_rs_tpu.parallel import mesh as mesh_mod
from nerf_rs_tpu.train import loop as loop_mod
from nerf_rs_tpu.train import step as step_mod

PRESETS = ["", "tiny", "full", "hierarchical", "record", "proposal",
           "pod", "ngp", "factored", "mipnerf", "unbounded"]


def _resolve(argv):
    args = build_parser().parse_args(argv)
    args._explicit = explicit_dests(argv)
    return config_from_args(args)


def _shrink(cfg):
    """Cut sample counts so the CPU run stays fast while preserving
    every routing-relevant field of the preset (proposal on/off,
    share_network, fine mode, occ grid)."""
    r = cfg.render
    r = dataclasses.replace(
        r,
        num_samples=min(r.num_samples, 16),
        num_fine_samples=min(r.num_fine_samples, 16),
    )
    updates = {"render": r}
    if cfg.proposal.enabled:
        updates["proposal"] = dataclasses.replace(
            cfg.proposal, num_samples=min(cfg.proposal.num_samples, 16)
        )
    return cfg.replace(**updates)


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_eval_render_runs(preset):
    argv = ["train"] + (["--preset", preset] if preset else [])
    cfg = _shrink(_resolve(argv))
    state = step_mod.init_state(jax.random.PRNGKey(0), cfg)
    m = mesh_mod.make_mesh()
    o, d = rays.ray_grid(None, cfg.camera)
    o, d = o[:8, :8], d[:8, :8]
    rgb, depth, acc = loop_mod.render_frame(
        cfg, step_mod.with_ema_params(state), o, d, m, chunk=32
    )
    assert rgb.shape == (8, 8, 3)
    assert np.isfinite(np.asarray(rgb)).all(), preset
    assert np.isfinite(np.asarray(depth)).all(), preset
