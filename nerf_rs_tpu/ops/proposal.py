"""Proposal-guided sampling + interlevel histogram loss (mip-NeRF 360
lineage, a capability beyond the reference — the reference's only
sampling is uniform-random t (src/ray_sampling.rs:96-142)).

Flow: uniform stratified ts -> tiny proposal MLP -> compositing
weights -> stratified inverse-CDF resample (ops/sampling.sample_pdf,
sorted by construction) -> the main NeRF evaluates ONLY the resampled
points. The proposal is trained with the interlevel bound loss: its
weight histogram must upper-bound the main network's, measured on
every main-sample interval.

Notes: the interval-overlap "outer" measure is one broadcast
compare + masked sum over a (rays, F, P) mask — the same gather-free
pattern as sample_pdf; no searchsorted, no sort, no dynamic shapes.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import CameraConfig, ProposalConfig
from ..models.proposal import apply_proposal
from . import sampling


def edges_from_ts(ts: jnp.ndarray) -> jnp.ndarray:
    """Histogram edges for sample distances: (..., S) -> (..., S+1),
    [t_0, midpoints, t_last] — the same construction hierarchical
    sampling uses for its PDF bins."""
    mids = 0.5 * (ts[..., 1:] + ts[..., :-1])
    return jnp.concatenate([ts[..., :1], mids, ts[..., -1:]], axis=-1)


def weights_from_sigma(sigma: jnp.ndarray, deltas: jnp.ndarray) -> jnp.ndarray:
    """Compositing weights w_i = T_i * (1 - exp(-sigma_i delta_i)) with
    O(S) exclusive-cumsum transmittance (ops/render.composite without
    the color reduction — the proposal has no colors)."""
    sd = sigma * deltas
    excl = jnp.cumsum(sd, axis=-1) - sd
    return jnp.exp(-excl) * (1.0 - jnp.exp(-sd))


def proposal_weights(
    prop_params, origins, dirs, ts_p, pcfg: ProposalConfig, far: float,
    dtype=None, contract: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(weights (..., P), edges (..., P+1)) of the proposal histogram
    along each ray — differentiable w.r.t. prop_params."""
    pts = sampling.points_from_ts(origins, dirs, ts_p)
    sigma_p = apply_proposal(prop_params, pts, pcfg, dtype,
                             contract=contract)
    deltas = sampling.deltas_from_ts(ts_p, far)
    return weights_from_sigma(sigma_p, deltas), edges_from_ts(ts_p)


def anneal_weights(w: jnp.ndarray, anneal) -> jnp.ndarray:
    """mip-NeRF 360 resampling annealing: exponentiate DRAW weights by
    ``anneal`` in (0, 1] (None = off). Applied per level; the interlevel
    loss always sees the raw histogram."""
    if anneal is None:
        return w
    return jnp.power(jnp.maximum(w, 1e-7), anneal)


def proposal_resample(
    key: jax.Array,
    origins: jnp.ndarray,
    dirs: jnp.ndarray,
    prop_params,
    pcfg: ProposalConfig,
    num_main_samples: int,
    camera: CameraConfig,
    randomized: bool,
    dtype=None,
    anneal=None,
    space: str = "linear",
    contract: bool = False,
) -> Tuple[jnp.ndarray, Tuple[Tuple[jnp.ndarray, jnp.ndarray], ...]]:
    """Main-network sample distances guided by ``pcfg.num_levels``
    rounds of resampling through the one shared proposal MLP:
    (ts_main (..., F) sorted, hists) where ``hists`` is one
    (edges (..., P+1), weights (..., P)) pair per level — weights carry
    gradients to prop_params; feed every pair to the interlevel loss
    (multi_interlevel_loss). Each draw stop-grads the weights (sampling
    positions are not a gradient path; the interlevel loss is), so
    level-(l+1) positions are constants w.r.t. prop_params."""
    keys = jax.random.split(key, pcfg.num_levels + 1)
    n = origins.shape[0]
    # only the LEVEL-0 draw has a space: later levels inverse-CDF
    # resample the previous histogram, which is space-free
    ts = sampling.stratified_ts(
        keys[0], n, pcfg.num_samples, camera.near, camera.far, randomized,
        space=space,
    )
    hists = []
    for lvl in range(pcfg.num_levels):
        w, bins = proposal_weights(
            prop_params, origins, dirs, ts, pcfg, camera.far, dtype,
            contract=contract,
        )
        hists.append((bins, w))
        w_draw = anneal_weights(jax.lax.stop_gradient(w), anneal)
        last = lvl == pcfg.num_levels - 1
        ts = sampling.sample_pdf(
            keys[lvl + 1], bins, w_draw,
            num_main_samples if last else pcfg.num_samples, randomized,
        )
    return ts, tuple(hists)


def multi_interlevel_loss(
    main_edges: jnp.ndarray,
    w_main: jnp.ndarray,
    hists,
) -> jnp.ndarray:
    """Sum of the interlevel bound loss over every proposal level's
    (edges, weights) histogram (mip-NeRF 360 applies it per level)."""
    total = 0.0
    for bins, w in hists:
        total = total + interlevel_loss(main_edges, w_main, bins, w)
    return total


def interlevel_loss(
    main_edges: jnp.ndarray,  # (..., F+1)
    w_main: jnp.ndarray,  # (..., F) main-network compositing weights
    prop_edges: jnp.ndarray,  # (..., P+1)
    w_prop: jnp.ndarray,  # (..., P) proposal weights (grads flow here)
    eps: float = 1e-3,
) -> jnp.ndarray:
    """mip-NeRF 360 proposal loss: penalize main-histogram mass the
    proposal envelope fails to cover.

    For each main interval i, the bound is the total proposal weight
    whose interval OVERLAPS it; loss = mean_rays sum_i
    max(0, w_main_i - bound_i)^2 / (w_main_i + eps). The main histogram
    is stop-gradded — this trains the proposal toward the main network,
    never the reverse.
    """
    w_main = jax.lax.stop_gradient(w_main)
    lo_m, hi_m = main_edges[..., :-1], main_edges[..., 1:]
    lo_p, hi_p = prop_edges[..., :-1], prop_edges[..., 1:]
    # (..., F, P) interval-overlap mask, then a masked sum over P — one
    # broadcast compare, no searchsorted/gather (see module docstring)
    overlap = (lo_p[..., None, :] < hi_m[..., :, None]) & (
        hi_p[..., None, :] > lo_m[..., :, None]
    )
    bound = jnp.sum(jnp.where(overlap, w_prop[..., None, :], 0.0), axis=-1)
    excess = jnp.maximum(0.0, w_main - bound)
    return jnp.mean(jnp.sum(excess**2 / (w_main + eps), axis=-1))
