"""Test env: force CPU with 8 virtual devices.

This is the standard way to exercise shard_map/psum/mesh code without
several accelerators (SURVEY.md §4 implication). Speed on the GPU is
measured by bench.py and chip_smoke.py, not the test suite.

Tests marked ``gpu`` need an NVIDIA card: the ``gpu_card`` fixture
skips them where there is none. They start their own process on the
card (this process stays on the CPU).
"""

import os
import shutil
import subprocess

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

assert jax.devices()[0].platform == "cpu", "tests must run on CPU"
assert len(jax.devices()) == 8, "tests expect 8 virtual CPU devices"


def pytest_configure(config):
    # two tiers: `-m "not slow"` is the ~3 min inner-loop tier; the full
    # suite (~11 min) stays the default and what CI runs
    config.addinivalue_line(
        "markers",
        "slow: >9s on the 8-virtual-device CPU suite (convergence runs, "
        "subprocess/e2e drives); deselect with -m 'not slow'",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA card (skips without one); run on the card "
        "with `python -m pytest tests -m gpu`",
    )


@pytest.fixture
def gpu_card() -> str:
    """The card's name as nvidia-smi reports it; skips the test where
    there is no NVIDIA card. Decided per test, never at import."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        pytest.skip("no NVIDIA card: nvidia-smi not found")
    r = subprocess.run([smi, "--query-gpu=name", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        pytest.skip(f"no NVIDIA card: nvidia-smi says {r.stderr.strip()!r}")
    return r.stdout.strip().splitlines()[0]
