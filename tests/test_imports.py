"""The card's machine has neither flax nor PIL: the main path must
import without them."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKED = """
import sys
for name in ("flax", "PIL"):
    sys.modules[name] = None  # any import of it raises ImportError
import nerf_rs_tpu.cli, nerf_rs_tpu.train.checkpoint, nerf_rs_tpu.data.images
import nerf_rs_tpu.train.loop
print("imported")
"""


def test_main_path_imports_without_flax_and_pil():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", BLOCKED], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "imported" in r.stdout


def test_bench_refuses_the_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "bench.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "'cpu'" in r.stderr
    assert '"metric"' not in r.stdout
