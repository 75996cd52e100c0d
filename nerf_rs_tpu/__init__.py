"""nerf_rs_tpu — a NeRF training/rendering framework in JAX.

JAX/XLA implementation of the full capability surface of the reference
(cadddr/nerf-rs, a Rust/tch-rs NeRF trainer): vectorized on-device ray
generation, PE+MLP+compositing compiled by XLA, data-parallel training
over a device mesh via shard_map/psum, and an async host pixel
pipeline. See SURVEY.md at
the repo root for the reference blueprint.
"""

from .config import (
    CameraConfig,
    Config,
    DataConfig,
    ModelConfig,
    ProposalConfig,
    RenderConfig,
    TrainConfig,
    reference_compat_config,
)

__version__ = "0.1.0"

__all__ = [
    "CameraConfig",
    "Config",
    "DataConfig",
    "ModelConfig",
    "ProposalConfig",
    "RenderConfig",
    "TrainConfig",
    "reference_compat_config",
]
