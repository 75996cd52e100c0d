"""Proposal density MLP (mip-NeRF 360 lineage): a tiny network whose
only job is to predict WHERE density is, so the expensive main MLP
spends its per-ray sample budget there.

The reference (and the original NeRF paper) runs the FULL radiance MLP
as the coarse pass — work whose rgb output is discarded at eval and
whose only training signal is a duplicated photometric loss. A 4x64
density-only proposal evaluates the same sample count at a small
fraction of the cost and is trained to bound the main network's weight
histogram instead (ops/proposal.interlevel_loss).

Pure pytree params + apply fn, same conventions as models/mlp.py
(He-normal init, bf16 compute / f32 master weights, f32 sigma out).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import ProposalConfig
from .encoding import posenc, posenc_dim
from .mlp import Params, _init_linear, dense


def init_proposal_params(key: jax.Array, pcfg: ProposalConfig) -> Params:
    pos_dim = posenc_dim(3, pcfg.pos_enc_levels, True)
    keys = jax.random.split(key, pcfg.net_depth + 1)
    trunk = []
    in_dim = pos_dim
    for i in range(pcfg.net_depth):
        trunk.append(_init_linear(keys[i], in_dim, pcfg.net_width))
        in_dim = pcfg.net_width
    return {
        "trunk": trunk,
        "sigma": _init_linear(keys[pcfg.net_depth], pcfg.net_width, 1),
    }


def apply_proposal(
    params: Params, points: jnp.ndarray, pcfg: ProposalConfig, dtype=None,
    contract: bool = False,
) -> jnp.ndarray:
    """Density at world ``points`` (..., 3) -> sigma (...,), relu'd f32.

    No view directions, no rgb head, no skip connection — at 4 layers
    the skip buys nothing, and density is all the resampler needs.
    ``contract``: unbounded configs (ModelConfig.contract) warp the
    proposal's points through the SAME contraction as the main field —
    the two networks must agree on the coordinate chart.
    """
    if contract:
        from ..ops.contract import contract as _contract

        points = _contract(points)
    x = posenc(points, pcfg.pos_enc_levels, True)
    if dtype is not None and dtype != jnp.float32:
        x = x.astype(dtype)
    h = x
    for layer in params["trunk"]:
        h = jax.nn.relu(dense(h, layer, dtype))
    raw = dense(h, params["sigma"], dtype)[..., 0].astype(jnp.float32)
    return jax.nn.relu(raw)
