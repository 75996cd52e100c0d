"""Radiance-field MLPs as pure pytree-params + apply functions.

Two architectures:
  * ``nerf``  — the paper-correct model the reference aspires to
    (its own comments flag the gaps, src/model.rs:46-47,154,175):
    gamma(x) -> 8x256 ReLU trunk with a skip connection re-injecting the
    encoded position at layer 5, sigma head (1) + feature head (256),
    then [feature, gamma(d)] -> 128 -> RGB sigmoid.
  * ``compat`` — the reference's committed architecture
    (src/model.rs:45-93): raw xyz -> 8x100 ReLU -> 101 (channel 0 =
    sigma, no activation; 1..101 = features), head 100 -> 50 ReLU ->
    4 sigmoid.

No NN framework: ~600k params is a dict of (w, b) leaves and a chain of
matmuls — exactly what XLA wants.

Weights are He-uniform initialized (fan_in), matching libtorch's
nn::Linear default so compat-mode convergence behavior is comparable.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp

from ..config import ModelConfig
from .encoding import posenc, posenc_dim

Params = Dict[str, Any]


def _init_linear(key: jax.Array, in_dim: int, out_dim: int) -> Dict[str, jnp.ndarray]:
    """He-normal weights (fan_in, ReLU gain) with zero biases.

    Variance-preserving init is load-bearing for the 8-deep trunk: with
    libtorch-default kaiming-uniform(a=sqrt(5)) + uniform biases,
    activations shrink layer-by-layer until the sigma head's bias
    dominates — if it lands negative, relu(sigma)=0 for EVERY point,
    all compositing weights are 0, and the whole network is dead at
    init (zero gradients). Zero biases + He weights
    keep sigma_raw zero-mean across points so gradient flows.
    """
    kw, _ = jax.random.split(key)
    std = math.sqrt(2.0 / in_dim)
    w = std * jax.random.truncated_normal(
        kw, -2.0, 2.0, (in_dim, out_dim), jnp.float32
    )
    b = jnp.zeros((out_dim,), jnp.float32)
    return {"w": w, "b": b}


def _init_linear_torch(key: jax.Array, in_dim: int, out_dim: int) -> Dict[str, jnp.ndarray]:
    """libtorch nn::Linear default (kaiming_uniform(a=sqrt(5)) for W ->
    bound sqrt(1/fan_in); U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for b) —
    used by compat mode so convergence behavior matches the reference's
    tch VarStore init."""
    kw, kb = jax.random.split(key)
    bound = 1.0 / math.sqrt(in_dim)
    w = jax.random.uniform(kw, (in_dim, out_dim), jnp.float32, -bound, bound)
    b = jax.random.uniform(kb, (out_dim,), jnp.float32, -bound, bound)
    return {"w": w, "b": b}


def dense(x: jnp.ndarray, layer: Dict[str, jnp.ndarray], dtype=None) -> jnp.ndarray:
    """y = x @ w + b.

    With dtype=bf16 the ENTIRE layer — inputs, weights, output, bias —
    runs in bf16 (master weights stay f32 in the param tree):
      * bf16 inter-layer activations halve the trunk's memory traffic;
      * bf16 matmul OUTPUTS keep the backward's cotangents in bf16
        through every dW/dx matmul.
    The tensor cores still accumulate bf16 products in f32 internally;
    only the stored result is rounded.
    """
    w, b = layer["w"], layer["b"]
    if dtype is not None and dtype != jnp.float32:
        return jnp.dot(
            x.astype(dtype), w.astype(dtype), preferred_element_type=dtype
        ) + b.astype(dtype)
    return jnp.dot(x, w, preferred_element_type=jnp.float32) + b


def _act(h: jnp.ndarray, dtype) -> jnp.ndarray:
    del dtype  # dense already emits the compute dtype
    return jax.nn.relu(h)


def init_nerf_params(key: jax.Array, cfg: ModelConfig) -> Params:
    """Build the parameter pytree for any architecture family
    (compat > arch: the reference-compat flag wins)."""
    if cfg.compat:
        return _init_compat(key, cfg)
    if cfg.arch == "hashgrid":
        from .hashgrid import init_hash_params

        return init_hash_params(key, cfg)
    if cfg.arch == "factored":
        from .factored import init_factored_params

        return init_factored_params(key, cfg)
    pos_dim = posenc_dim(3, cfg.pos_enc_levels, cfg.include_input_in_enc)
    dir_dim = posenc_dim(3, cfg.dir_enc_levels, cfg.include_input_in_enc)
    keys = jax.random.split(key, cfg.net_depth + 5)
    trunk = []
    in_dim = pos_dim
    for i in range(cfg.net_depth):
        if i == cfg.skip_layer and i > 0:
            in_dim += pos_dim
        trunk.append(_init_linear(keys[i], in_dim, cfg.net_width))
        in_dim = cfg.net_width
    k = cfg.net_depth
    params: Params = {
        "trunk": trunk,
        "sigma": _init_linear(keys[k], cfg.net_width, 1),
        "feature": _init_linear(keys[k + 1], cfg.net_width, cfg.feature_width),
    }
    if cfg.use_viewdirs:
        params["view1"] = _init_linear(
            keys[k + 2], cfg.feature_width + dir_dim, cfg.view_head_width
        )
        params["rgb"] = _init_linear(keys[k + 3], cfg.view_head_width, 3)
    else:
        params["rgb"] = _init_linear(keys[k + 3], cfg.feature_width, 3)
    return params


def _init_compat(key: jax.Array, cfg: ModelConfig) -> Params:
    """Reference architecture: DensityNet 3->100x7->101
    (src/model.rs:45-67) + RadianceNet 100->50->4 (src/model.rs:86-93)."""
    w = cfg.compat_width
    keys = jax.random.split(key, 10)
    trunk = [_init_linear_torch(keys[0], 3, w)]
    for i in range(1, 7):
        trunk.append(_init_linear_torch(keys[i], w, w))
    trunk.append(_init_linear_torch(keys[7], w, w + 1))
    return {
        "trunk": trunk,
        "head1": _init_linear_torch(keys[8], w, cfg.compat_head_width),
        "head2": _init_linear_torch(keys[9], cfg.compat_head_width, 4),
    }


def _sigma_act(raw: jnp.ndarray, cfg: ModelConfig) -> jnp.ndarray:
    if cfg.sigma_activation == "relu":
        return jax.nn.relu(raw)
    if cfg.sigma_activation == "softplus":
        return jax.nn.softplus(raw)
    return raw  # compat: raw fc8 output, can go negative (src/model.rs:168-171)


def apply_nerf(
    params: Params,
    points: jnp.ndarray,
    viewdirs: jnp.ndarray,
    cfg: ModelConfig,
    dtype=None,
    noise_std: float = 0.0,
    noise_key: jax.Array = None,
    pos_var: jnp.ndarray = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Evaluate the radiance field.

    Args:
      params: pytree from init_nerf_params.
      points: (..., 3) world-space sample points.
      viewdirs: (..., 3) unit view directions (broadcastable to points),
        or None when cfg.use_viewdirs is False.
      dtype: matmul dtype (jnp.bfloat16 for mixed precision).
      noise_std/noise_key: paper-appendix regularizer — Gaussian noise
        added to RAW sigma BEFORE the activation (the paper perturbs
        pre-activation density; adding it post-relu changes semantics).
      pos_var: (..., 3) diagonal covariance of each sample Gaussian
        (mip-NeRF IPE; used when cfg.ipe — `points` is then the mean).
    Returns:
      sigma (...,) after cfg.sigma_activation, rgb (..., 3) in [0,1]
      (for compat: rgba (..., 4) — channel semantics of
      src/model.rs:119-131).
    """
    if cfg.compat:
        return _apply_compat(params, points, cfg, dtype, noise_std, noise_key)
    if cfg.contract:
        # mip-NeRF 360 scene contraction (ops/contract.py): every family
        # then encodes the bounded radius-2 domain; IPE Gaussians push
        # through the closed-form linearization. Upstream of the arch
        # dispatch on purpose — one hook covers PE/IPE/hash/factored.
        from ..ops.contract import contract, contract_gaussian

        if pos_var is not None:
            points, pos_var = contract_gaussian(points, pos_var)
        else:
            points = contract(points)
    if cfg.arch in ("hashgrid", "factored"):
        if cfg.arch == "hashgrid":
            from .hashgrid import apply_hashgrid as apply_fn
        else:
            from .factored import apply_factored as apply_fn

        sigma_raw, rgb_raw = apply_fn(params, points, viewdirs, cfg, dtype)
        rgb = (
            jax.nn.sigmoid(rgb_raw)
            if cfg.rgb_activation == "sigmoid" else rgb_raw
        )
        sigma_raw = _sigma_noise(sigma_raw, noise_std, noise_key)
        return _sigma_act(sigma_raw, cfg), rgb
    if cfg.ipe and pos_var is not None:
        # mip-NeRF: `points` is the Gaussian mean, pos_var its diagonal
        # covariance; the encoding dim matches posenc so the same trunk
        # weights serve both (models/encoding.integrated_posenc)
        from .encoding import integrated_posenc

        x = integrated_posenc(
            points, pos_var, cfg.pos_enc_levels, cfg.include_input_in_enc
        )
    else:
        x = posenc(points, cfg.pos_enc_levels, cfg.include_input_in_enc)
    if dtype is not None and dtype != jnp.float32:
        x = x.astype(dtype)
    h = x
    for i, layer in enumerate(params["trunk"]):
        if i == cfg.skip_layer and i > 0:
            h = jnp.concatenate([h, x], axis=-1)
        h = _act(dense(h, layer, dtype), dtype)
    # heads: cast to f32 on the way out — compositing (exp/cumsum) and
    # the loss run in f32; the cast's backward re-enters the trunk in
    # the compute dtype, so cotangents stay bf16 where it matters.
    sigma_raw = dense(h, params["sigma"], dtype)[..., 0].astype(jnp.float32)
    feat = dense(h, params["feature"], dtype)
    if cfg.use_viewdirs:
        d = posenc(viewdirs, cfg.dir_enc_levels, cfg.include_input_in_enc)
        d = jnp.broadcast_to(d, feat.shape[:-1] + (d.shape[-1],))
        if dtype is not None and dtype != jnp.float32:
            d = d.astype(dtype)
        hv = _act(dense(jnp.concatenate([feat, d], axis=-1), params["view1"], dtype), dtype)
        rgb_raw = dense(hv, params["rgb"], dtype).astype(jnp.float32)
    else:
        rgb_raw = dense(feat, params["rgb"], dtype).astype(jnp.float32)
    rgb = jax.nn.sigmoid(rgb_raw) if cfg.rgb_activation == "sigmoid" else rgb_raw
    sigma_raw = _sigma_noise(sigma_raw, noise_std, noise_key)
    return _sigma_act(sigma_raw, cfg), rgb


def _sigma_noise(
    sigma_raw: jnp.ndarray, noise_std: float, noise_key
) -> jnp.ndarray:
    if noise_std > 0.0 and noise_key is not None:
        return sigma_raw + noise_std * jax.random.normal(
            noise_key, sigma_raw.shape, sigma_raw.dtype
        )
    return sigma_raw


def _apply_compat(
    params: Params, points: jnp.ndarray, cfg: ModelConfig, dtype=None,
    noise_std: float = 0.0, noise_key: jax.Array = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Reference forward: 8 linears with ReLU between (none after fc8,
    src/model.rs:96-117); channel 0 = sigma (raw), 1.. = features
    (src/model.rs:168-176); radiance head ReLU+sigmoid
    (src/model.rs:119-131). Viewing direction is NOT an input — the
    quirk the reference admits at src/model.rs:154,175."""
    h = points
    trunk = params["trunk"]
    for layer in trunk[:-1]:
        h = _act(dense(h, layer, dtype), dtype)
    out = dense(h, trunk[-1], dtype)
    sigma_raw = _sigma_noise(
        out[..., 0].astype(jnp.float32), noise_std, noise_key
    )
    feat = out[..., 1:]
    h2 = _act(dense(feat, params["head1"], dtype), dtype)
    rgba = jax.nn.sigmoid(dense(h2, params["head2"], dtype).astype(jnp.float32))
    return _sigma_act(sigma_raw, cfg), rgba


def count_params(params: Params) -> int:
    return sum(int(p.size) for p in jax.tree_util.tree_leaves(params))
