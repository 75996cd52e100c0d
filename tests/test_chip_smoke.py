"""chip_smoke.py on the CPU: it refuses to run here, and each of its
phase functions runs at a tiny width with the platform injected (the
card runs them at full width through main)."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def shrink(cfg):
    """Every field family at a width the CPU runs in seconds; sample
    counts, presets' mechanisms and the 16x16 camera stay structural."""
    m = dataclasses.replace(
        cfg.model, net_depth=4, net_width=32, skip_layer=2, feature_width=32,
        view_head_width=16, pos_enc_levels=4, dir_enc_levels=2,
        hash_levels=4, hash_table_log2=10, hash_max_res=64,
        hash_mlp_width=16, fac_levels=3, fac_max_res=64, fac_comps=8)
    r = dataclasses.replace(
        cfg.render, num_samples=8,
        num_fine_samples=8 if cfg.render.num_fine_samples else 0,
        occ_res=8 if cfg.render.occ_res else 0, occ_bins=8)
    p = dataclasses.replace(cfg.proposal, num_samples=8, net_width=16)
    return dataclasses.replace(
        cfg, model=m, render=r, proposal=p,
        train=dataclasses.replace(cfg.train, num_rays=64),
        camera=dataclasses.replace(cfg.camera, width=16, height=16))


TINY = cs.Scale(train_steps=50, num_rays=64, num_samples=8, train_hw=16,
                render_hw=16, preset_steps=2, time_steps=2, dp_steps=2,
                store_steps=6, min_psnr=None, check_disk=False, adapt=shrink)


def _run_script(args, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_the_cpu():
    r = _run_script(["chip_smoke.py"], REPO)
    assert r.returncode != 0
    assert "'cpu'" in r.stderr + r.stdout
    assert '"ok": true' not in r.stdout


def test_fails_without_the_package(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_script(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert "nerf_rs_tpu" in r.stderr
    assert '"ok": true' not in r.stdout


def test_phase_device_refuses_cpu():
    with pytest.raises(SystemExit, match="'cpu'"):
        cs.phase_device(platform="cpu", cards=[])


def test_phase_device_names_the_card(capsys):
    found = cs.phase_device(platform="gpu",
                            cards=["NVIDIA H100 80GB HBM3, 700.00 W"])
    assert found["count"] == len(jax.devices())
    assert found["platform"] == "gpu"
    assert "card: NVIDIA H100 80GB HBM3, 700.00 W" in capsys.readouterr().out


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    ctx = {}
    run = str(tmp_path_factory.mktemp("smoke") / "flagship")
    found = cs.phase_flagship(run, TINY, ctx)
    return found, ctx


def test_phase_flagship(flagship):
    found, ctx = flagship
    assert np.isfinite(found["loss"]) and found["loss"] > 0
    assert found["train_psnr"] == pytest.approx(-10 * np.log10(found["loss"]))
    assert np.isfinite(found["eval_mean_psnr"])
    assert found["step_ms"] > 0 and found["step_compile_s"] > 0
    assert os.path.exists(os.path.join(ctx["run"], "render", "view-0.png"))
    # the step it timed is the CLI's flagship step
    assert ctx["cfg"].model.net_width == 256
    assert ctx["cfg"].train.precision == "mixed"


def test_phase_reference(flagship):
    _, ctx = flagship
    gap = cs.phase_reference(TINY, ctx)
    for weights in ("init", "trained"):
        assert gap[weights]["loss_rel"] <= cs.LOSS_RTOL
    assert not gap["init"]["grad_leaves_off"]
    assert "grad_cos" in gap["trained"]  # reported, not bounded
    for frame in ("frame_init", "frame_trained"):
        assert gap[frame]["off_share"] <= cs.FRAME_OFF_SHARE
        assert gap[frame]["mean_abs"] <= cs.FRAME_MEAN_ATOL


def test_phase_memory(flagship):
    _, ctx = flagship
    found = cs.phase_memory(TINY, ctx)
    assert found["train_step"]["temp_size_in_bytes"] > 0
    assert found["render_chunk"]["rays"] == TINY.render_hw ** 2


@pytest.mark.parametrize("preset", cs.PRESETS)
def test_phase_presets(preset):
    found = cs.phase_presets(TINY, presets=(preset,))[preset]
    assert len(found["losses"]) == TINY.preset_steps
    assert found["loss_rel"] <= cs.LOSS_RTOL


def test_check_gap_rejects_a_wrong_loss():
    gap = {"loss": 0.1, "loss_ref": 0.2, "loss_rel": 0.5,
           "f32_loss_rel": 0.0}
    with pytest.raises(cs.PhaseFailed, match="loss differs"):
        cs._check_gap(gap, "x")
    gap.update(loss_rel=0.0, grad_leaves_off={"['w']": {"cos": 0.5,
                                                        "share": 0.1}})
    with pytest.raises(cs.PhaseFailed, match="cosine"):
        cs._check_gap(gap, "x")
    gap["grad_leaves_off"] = {}
    cs._check_gap(gap, "x")
    gap["grad_leaves_off"] = {"['w']": {"cos": 0.5, "share": 0.1}}
    cs._check_gap(gap, "x", grads=False)


@pytest.fixture(scope="module")
def four():
    return jax.devices()[:4]


def test_phase_four_dp(four):
    ctx = {}
    found = cs.phase_four_dp(four, TINY, ctx)
    assert found["loss_rel"] <= cs.DP_LOSS_RTOL
    assert found["update_rel"] <= cs.DP_UPDATE_RTOL
    assert "dp_params" in ctx


def test_phase_four_render(four):
    found = cs.phase_four_render(four, TINY, {})
    assert found["frame"] == [16, 16, 3]
    assert found["f32_4_vs_1"]["off_share"] <= cs.SHARD_F32_OFF_SHARE
    assert found["bf16_4_vs_1"]["mean_abs"] <= cs.FRAME_MEAN_ATOL


def test_phase_four_store(four):
    found = cs.phase_four_store(four, TINY)
    assert found["sharded"]["last"] < found["sharded"]["first"]


def test_phase_four_scenes(four):
    found = cs.phase_four_scenes(four, TINY)
    assert set(found) == {"scene_0", "scene_1"}


def _fake_phases(monkeypatch, fail=None):
    monkeypatch.setattr(cs, "phase_device", lambda: {"platform": "gpu"})
    for name in ("phase_flagship", "phase_reference", "phase_presets",
                 "phase_memory"):
        def fn(*a, _n=name, **k):
            if _n == fail:
                raise cs.PhaseFailed("injected")
            return {}
        monkeypatch.setattr(cs, name, fn)


def test_main_last_line(monkeypatch, capsys, tmp_path):
    _fake_phases(monkeypatch)
    assert cs.main(["--out", str(tmp_path)]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    d = jax.devices()
    assert json.loads(last) == {"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}


def test_main_fails_when_a_phase_fails(monkeypatch, capsys, tmp_path):
    _fake_phases(monkeypatch, fail="phase_reference")
    assert cs.main(["--out", str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert '"ok": true' not in out
    assert "phase reference: FAILED" in out
    # the phases after the failed one still ran
    assert "phase memory: ok" in out


ON_THE_CARD = """
import jax
import chip_smoke as cs
from nerf_rs_tpu.data.factory import make_dataset
from nerf_rs_tpu.train import step as step_mod

assert jax.devices()[0].platform == "gpu", jax.devices()
cfg = cs.cli_config(cs.flagship_argv("train", "runs/gpu_test", cs.FULL))
state = step_mod.init_state(jax.random.PRNGKey(0), cfg)
batch = make_dataset(cfg).sample_batch(jax.random.PRNGKey(1), 4096)
gap = cs.reference_gap(cfg, step_mod._trainable(state, cfg), batch,
                       jax.random.PRNGKey(2))
cs._check_gap(gap, "flagship")
print("gap", gap)
"""


@pytest.mark.gpu
def test_flagship_matches_reference_on_the_card(gpu_card):
    """The flagship's bf16 loss and gradients at 4096 rays x 64 samples
    against the f32 reference, compiled for the card (this process
    stays on the CPU, so the check runs in a child process)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run([sys.executable, "-c", ON_THE_CARD], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, f"{gpu_card}: {r.stderr[-3000:]}"
    assert "gap" in r.stdout
