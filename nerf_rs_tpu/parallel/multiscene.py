"""Multi-scene training: one radiance field per scene, scenes sharded
across the device mesh (BASELINE config 5).

"Train many scenes on several devices": stack every model/optimizer
leaf along a leading scene axis, vmap the single-scene train step over
that axis, and shard the axis over the mesh — each device (group)
advances its own scene with ZERO cross-device collectives (scene
training is embarrassingly parallel; the mesh is used for placement,
not communication). With more scenes than devices, each device holds
several scenes, vmapped.

Composes with everything single-scene: checkpointing stores the stacked
state; `scene_state(ms, i)` slices one scene out for rendering/eval.
"""

from __future__ import annotations

from typing import List, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import Config
from ..train import step as step_mod
from ..train.step import Batch, TrainState
from .mesh import DATA_AXIS, SCENE_AXIS, num_shards


def init_multiscene_state(key: jax.Array, cfg: Config, n_scenes: int) -> TrainState:
    """Stacked TrainState: every leaf gains a leading (n_scenes,) axis;
    each scene gets an independent init key."""
    keys = jax.random.split(key, n_scenes)
    return jax.vmap(lambda k: step_mod.init_state(k, cfg))(keys)


def scene_state(ms: TrainState, scene: int) -> TrainState:
    """Slice one scene's TrainState out of the stack."""
    return jax.tree_util.tree_map(lambda x: x[scene], ms)


def stack_batches(batches: Sequence[Batch]) -> Batch:
    """(S,) per-scene batches -> one stacked Batch with leading S."""
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *batches)


def make_multiscene_train_step(cfg: Config, mesh: Mesh, n_scenes: int):
    """(stacked_state, stacked_batch, key) -> (stacked_state, stacked_aux).

    On a 1-D ('data') mesh the scene axis is sharded over it directly
    (n_scenes must divide the mesh size). On a 2-D ('scene', 'data')
    mesh from make_scene_mesh, scenes shard over the scene axis and each
    scene's rays are data-parallel within its group: grads psum over
    'data' only — scene groups never communicate.
    """
    two_d = SCENE_AXIS in mesh.shape
    scene_axis = SCENE_AXIS if two_d else DATA_AXIS
    nshards = mesh.shape[scene_axis]
    assert n_scenes % nshards == 0, (
        f"{n_scenes} scenes must divide over {nshards} scene shards"
    )

    def _local(states, batches, key):
        # each shard holds n_scenes/nshards scenes; vmap over them
        shard = jax.lax.axis_index(scene_axis)
        keys = jax.vmap(
            lambda i: jax.random.fold_in(jax.random.fold_in(key, shard), i)
        )(jnp.arange(n_scenes // nshards))
        if not two_d:
            return jax.vmap(
                lambda st, b, k: step_mod.train_step_core(st, b, k, cfg)
            )(states, batches, keys)

        # 2-D: per-scene DP step — grads pmean over the data axis
        # between backward and update (the dp.py recipe, vmapped over
        # the shard's local scenes)
        opt = step_mod.make_optimizer(cfg)
        dshard = jax.lax.axis_index(DATA_AXIS)

        def _scene_step(state, batch, k):
            k = jax.random.fold_in(k, dshard)
            trainable = step_mod._trainable(state, cfg)
            (_, aux), grads = jax.value_and_grad(
                step_mod.loss_fn, has_aux=True
            )(trainable, batch, k, cfg, state.grid, state.step)
            ray_err = aux.pop("ray_err")  # per-ray, stays sharded
            grads = jax.lax.pmean(grads, DATA_AXIS)
            aux = jax.lax.pmean(aux, DATA_AXIS)
            aux["ray_err"] = ray_err
            return step_mod.apply_grads(state, trainable, grads, opt, cfg), aux

        return jax.vmap(_scene_step)(states, batches, keys)

    if not two_d:
        sharded = jax.shard_map(
            _local,
            mesh=mesh,
            in_specs=(P(DATA_AXIS), P(DATA_AXIS), P()),
            out_specs=(P(DATA_AXIS), P(DATA_AXIS)),
            check_vma=False,
        )
        return jax.jit(sharded, donate_argnums=(0,))

    aux_spec = {
        "loss": P(SCENE_AXIS), "loss_coarse": P(SCENE_AXIS),
        "psnr": P(SCENE_AXIS),
        "ray_err": P(SCENE_AXIS, DATA_AXIS),
    }
    if cfg.render.num_fine_samples > 0:
        aux_spec["loss_fine"] = P(SCENE_AXIS)
    if cfg.proposal.enabled:
        aux_spec["loss_prop"] = P(SCENE_AXIS)
    if cfg.train.distortion_weight > 0.0:
        aux_spec["loss_dist"] = P(SCENE_AXIS)
    sharded = jax.shard_map(
        _local,
        mesh=mesh,
        in_specs=(P(SCENE_AXIS), P(SCENE_AXIS, DATA_AXIS), P()),
        out_specs=(P(SCENE_AXIS), aux_spec),
        check_vma=False,
    )
    return jax.jit(sharded, donate_argnums=(0,))


class MultiSceneSampler:
    """Stacks per-scene batches from a list of DeviceDatasets (all
    scenes must share H/W so ray counts match)."""

    def __init__(self, datasets: List):
        assert len(datasets) > 0
        self.datasets = datasets

    def sample(self, key: jax.Array, num_rays: int) -> Batch:
        batches = [
            ds.sample_batch(jax.random.fold_in(key, i), num_rays)
            for i, ds in enumerate(self.datasets)
        ]
        return stack_batches(batches)
