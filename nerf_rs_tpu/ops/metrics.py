"""Image-quality metrics beyond PSNR.

The reference computes no quality metric at all (only the MSE train
loss, src/model.rs:296-299); PSNR lives in ops/render.py. This module
adds SSIM (Wang et al. 2004), the second metric every NeRF paper
reports, so eval output matches the field's standard (PSNR / SSIM)
pair. Pure-JAX: an 11-tap separable Gaussian window (sigma 1.5) over
each channel, the parameterization used by the original paper and the
common NeRF eval stacks.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _gaussian_kernel(size: int, sigma: float) -> jnp.ndarray:
    x = jnp.arange(size, dtype=jnp.float32) - (size - 1) / 2.0
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    return k / jnp.sum(k)


def _filter2(img: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """Separable 'valid' convolution of (H, W, C) with a 1-D kernel
    applied along H then W (channels independent)."""
    # (H, W, C) -> conv along H: treat (W*C) columns as batch lanes
    def conv1d(a, axis):
        a = jnp.moveaxis(a, axis, -1)  # (..., N)
        shape = a.shape
        flat = a.reshape(-1, 1, shape[-1])  # (B, 1, N) NCW
        # HIGHEST precision is load-bearing: on the GPU a float32 conv
        # otherwise runs in TF32 (10-bit mantissa, eps ~1e-3), and the
        # variance terms E[x^2] - E[x]^2 then cancel catastrophically
        # against C2 = 9e-4.
        out = jax.lax.conv_general_dilated(
            flat, kernel.reshape(1, 1, -1), window_strides=(1,),
            padding="VALID", precision=jax.lax.Precision.HIGHEST,
        )
        return jnp.moveaxis(out.reshape(shape[:-1] + (-1,)), -1, axis)

    return conv1d(conv1d(img, 0), 1)


@functools.partial(jax.jit, static_argnames=("max_val", "filter_size"))
def ssim(
    img1: jnp.ndarray,
    img2: jnp.ndarray,
    max_val: float = 1.0,
    filter_size: int = 11,
    filter_sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> jnp.ndarray:
    """Mean SSIM between two (H, W, C) images in [0, max_val].

    Standard single-scale SSIM: local Gaussian-weighted means/variances
    (11x11, sigma 1.5, valid padding), averaged over space and channels.
    """
    img1 = img1.astype(jnp.float32)
    img2 = img2.astype(jnp.float32)
    kernel = _gaussian_kernel(filter_size, filter_sigma)
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2

    mu1 = _filter2(img1, kernel)
    mu2 = _filter2(img2, kernel)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    # E[x^2] - E[x]^2 (clamped: valid-window float error can dip <0)
    s1 = jnp.maximum(_filter2(img1 * img1, kernel) - mu1_sq, 0.0)
    s2 = jnp.maximum(_filter2(img2 * img2, kernel) - mu2_sq, 0.0)
    s12 = _filter2(img1 * img2, kernel) - mu12

    num = (2.0 * mu12 + c1) * (2.0 * s12 + c2)
    den = (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2)
    return jnp.mean(num / den)
