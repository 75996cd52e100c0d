"""Pin the bench-of-record path to the CLI path (VERDICT r4 task 6).

bench.py constructs its flagship Config directly, so a CLI-surface
regression (a parser default silently changing what every CLI user
runs while bench keeps measuring something else) cannot be caught by
bench itself. This test resolves the equivalent user-facing commands
THROUGH cli.config_from_args and asserts the hot-path fields match what
bench.py measures — a divergence between the bench path and the CLI
path fails CI, not a review.
"""

from nerf_rs_tpu.cli import build_parser, config_from_args, explicit_dests

import bench


def _resolve(argv):
    args = build_parser().parse_args(argv)
    args._explicit = explicit_dests(argv)
    return config_from_args(args)


def test_bench_train_path_matches_cli_flagship():
    bench_cfg = bench.flagship_config()
    # the flagship CLI training config is `train --preset full`
    cli_cfg = _resolve(["train", "--preset", "full"])
    assert cli_cfg.train.num_rays == bench_cfg.train.num_rays
    assert cli_cfg.train.precision == bench_cfg.train.precision
    assert cli_cfg.render.num_samples == bench_cfg.render.num_samples
    assert cli_cfg.render.num_fine_samples == bench_cfg.render.num_fine_samples
    assert cli_cfg.model.arch == bench_cfg.model.arch
    assert cli_cfg.model.net_depth == bench_cfg.model.net_depth
    assert cli_cfg.model.net_width == bench_cfg.model.net_width


def test_bench_render_path_matches_cli_render():
    """The secondary bench metric (800x800 render) must ride the same
    render path a `render` CLI invocation resolves to."""
    bench_cfg = bench.flagship_config()
    cli_cfg = _resolve(["render", "--save_dir", "/tmp/x",
                        "--width", "800", "--height", "800"])
    assert cli_cfg.train.precision == bench_cfg.train.precision
    assert cli_cfg.model == bench_cfg.model
    assert cli_cfg.render.num_samples == bench_cfg.render.num_samples
