"""Entry-point smoke tests: __graft_entry__.entry() compiles and
runs, dryrun_multichip exercises the full DP step on the virtual CPU
mesh."""

import pytest
import sys

sys.path.insert(0, ".")

import jax
import numpy as np


pytestmark = pytest.mark.slow  # e2e/subprocess drives

def test_entry_forward():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (1024, 3)
    assert np.isfinite(np.asarray(out)).all()


def test_dryrun_multichip_8():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)  # asserts internally


def test_bench_importable():
    import bench  # noqa: F401  (main() runs on the GPU only)

    assert callable(bench.main)
