"""Input encodings: sinusoidal positional encoding + the reference's
screen-space transforms.

The reference declares Fourier/coconet screen-coordinate encodings
(src/input_transforms.rs:3-59) but never wires them into the committed
path (SURVEY.md §2.10); its MLP consumes raw xyz. Here sinusoidal PE is
first-class (paper §5.1: gamma with L=10 for position, L=4 for
direction) and the screen-space encodings are kept as optional 2D-fit
utilities for parity with the reference's declared surface.
"""

from __future__ import annotations

import jax.numpy as jnp


def posenc(x: jnp.ndarray, levels: int, include_input: bool = True) -> jnp.ndarray:
    """NeRF sinusoidal encoding gamma(x) (paper eq. 4).

    gamma(p) = (sin(2^0 p), cos(2^0 p), ..., sin(2^{L-1} p), cos(2^{L-1} p))
    applied elementwise; output dim = D*(2*levels [+1]).

    Frequencies are ordered level-major [sin(2^l x), cos(2^l x)]_l with
    the raw input prepended when include_input.
    """
    if levels == 0:
        return x
    scales = 2.0 ** jnp.arange(levels, dtype=x.dtype)  # (L,)
    xb = x[..., None, :] * scales[:, None]  # (..., L, D)
    four = jnp.concatenate([jnp.sin(xb), jnp.cos(xb)], axis=-1)  # (..., L, 2D)
    flat = four.reshape(*x.shape[:-1], -1)
    if include_input:
        return jnp.concatenate([x, flat], axis=-1)
    return flat


def posenc_dim(in_dim: int, levels: int, include_input: bool = True) -> int:
    if levels == 0:
        return in_dim
    return in_dim * (2 * levels + (1 if include_input else 0))


def integrated_posenc(
    mean: jnp.ndarray,
    var: jnp.ndarray,
    levels: int,
    include_input: bool = True,
) -> jnp.ndarray:
    """mip-NeRF integrated positional encoding (arXiv 2103.13415 eq. 14).

    Encodes a diagonal Gaussian (mean, var) instead of a point: the
    expected sinusoid under the Gaussian is the sinusoid of the mean
    damped by exp(-freq^2 var / 2), so frequencies whose period is
    smaller than the sample footprint self-attenuate toward zero —
    the anti-aliasing mechanism. Output layout and dim match
    ``posenc`` exactly (include_input prepends the mean), so the same
    MLP weights consume either encoding; var -> 0 reduces to posenc.
    """
    if levels == 0:
        return mean
    scales = 2.0 ** jnp.arange(levels, dtype=mean.dtype)  # (L,)
    xb = mean[..., None, :] * scales[:, None]  # (..., L, D)
    damp = jnp.exp(-0.5 * var[..., None, :] * (scales * scales)[:, None])
    four = jnp.concatenate(
        [jnp.sin(xb) * damp, jnp.cos(xb) * damp], axis=-1
    )  # (..., L, 2D)
    flat = four.reshape(*mean.shape[:-1], -1)
    if include_input:
        return jnp.concatenate([mean, flat], axis=-1)
    return flat


# ---------------------------------------------------------------------------
# Screen-space encodings from the reference (src/input_transforms.rs),
# vectorized. Inputs are (..., 2) pixel coords as (row y, col x), matching
# the reference's [usize; 2] index order.
# ---------------------------------------------------------------------------


def screen_identity(e: jnp.ndarray) -> jnp.ndarray:
    """identity (src/input_transforms.rs:3-8)."""
    return jnp.asarray(e, jnp.float32)


def screen_scale(e: jnp.ndarray, height: int, width: int) -> jnp.ndarray:
    """scale_by_screen_size (src/input_transforms.rs:14-19)."""
    e = jnp.asarray(e, jnp.float32)
    return e / jnp.asarray([height, width], jnp.float32)


def _center(e: jnp.ndarray) -> jnp.ndarray:
    """center (src/input_transforms.rs:21-26): (1-y-0.5, x-0.5)."""
    return jnp.stack([1.0 - e[..., 0] - 0.5, e[..., 1] - 0.5], axis=-1)


def screen_scale_center(e: jnp.ndarray, height: int, width: int) -> jnp.ndarray:
    """scale_by_screen_size_and_center (src/input_transforms.rs:10-12)."""
    return _center(screen_scale(e, height, width))


def screen_coconet(e: jnp.ndarray, height: int, width: int) -> jnp.ndarray:
    """corners_and_polar 6-dim 'coconet' encoding
    (src/input_transforms.rs:28-42): (y, x, 1-y, 1-x, r, 1/tan(y/x))
    of the scaled+centered coordinate."""
    s = screen_scale(e, height, width)
    c = _center(s)
    r = jnp.sqrt(c[..., 0] ** 2 + c[..., 1] ** 2)
    cot = 1.0 / jnp.tan(c[..., 0] / (c[..., 1] + 1e-6) + 1e-6)
    return jnp.stack(
        [s[..., 0], s[..., 1], 1.0 - s[..., 0], 1.0 - s[..., 1], r, cot],
        axis=-1,
    )


def screen_fourier(e: jnp.ndarray, height: int, width: int, out_dim: int) -> jnp.ndarray:
    """fourier_features (src/input_transforms.rs:44-59), quirks preserved:
    only the first out_dim/2 slots are filled, alternating
    sin(2^(i/2) * x) at even i and cos(2^(i/2) * y) at odd i over the
    scaled+centered coordinate; the rest stay zero."""
    c = screen_scale_center(e, height, width)
    feats = []
    half = out_dim // 2
    for i in range(half):
        scale = 2.0 ** (i // 2)
        if i % 2 == 0:
            feats.append(jnp.sin(scale * c[..., 1]))
        else:
            feats.append(jnp.cos(scale * c[..., 0]))
    zeros = [jnp.zeros_like(c[..., 0])] * (out_dim - half)
    return jnp.stack(feats + zeros, axis=-1)
