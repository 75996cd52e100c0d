"""Checkpoint save/restore: params + optimizer state + step.

The reference saves libtorch VarStore archives named
``checkpoints/checkpoint-{unix_ts}-{iter}.ot`` (src/main.rs:81-83,
src/model.rs:211-217) and resumes via --load_path — but drops optimizer
state and the step counter (SURVEY §3.4: Adam moments reset on resume).
Here the full TrainState round-trips, the name pattern is preserved
(``checkpoint-{unix_ts}-{iter}.npz``), and ``latest_checkpoint``
enables auto-resume-from-latest (SURVEY §5.3 rebuild plan).

Format: one numpy ``.npz`` archive holding every array leaf of the
TrainState under the name ``"<field>/<key path>"`` (the field of
TrainState, then ``jax.tree_util.keystr`` of the leaf inside it). A
restore walks the TEMPLATE's tree (a freshly-initialized state for the
same Config) and looks each leaf up by that name, so the file needs no
pickled structure and loads with ``allow_pickle=False``.
"""

from __future__ import annotations

import os
import re
import time
import warnings
from typing import Dict, Optional

import jax
import numpy as np

from .step import TrainState

_CKPT_RE = re.compile(r"checkpoint-(\d+)-(\d+)\.npz$")


def checkpoint_path(save_dir: str, step: int, ts: Optional[int] = None) -> str:
    ts = int(time.time()) if ts is None else ts
    return os.path.join(save_dir, f"checkpoint-{ts}-{step}.npz")


def _flatten(field: str, tree) -> Dict[str, np.ndarray]:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {f"{field}/{jax.tree_util.keystr(p)}": np.asarray(v)
            for p, v in leaves}


def _fields_in(arrays) -> set:
    return {name.split("/", 1)[0] for name in arrays}


def _unflatten(field: str, template, arrays, path: str):
    """``template``'s tree with every leaf replaced by the stored array
    of the same name; raises when a leaf is missing or differs in
    shape (the checkpoint was saved from another config)."""

    def leaf(p, tpl):
        name = f"{field}/{jax.tree_util.keystr(p)}"
        if name not in arrays:
            raise KeyError(f"checkpoint {path} has no leaf {name!r}: it "
                           f"was saved from a different configuration")
        v = arrays[name]
        if v.shape != np.shape(tpl):
            raise ValueError(f"checkpoint {path}: leaf {name!r} has shape "
                             f"{v.shape}, the config expects "
                             f"{np.shape(tpl)}")
        return v.astype(np.asarray(tpl).dtype, copy=False)

    return jax.tree_util.tree_map_with_path(leaf, template)


def _load(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {name: z[name] for name in z.files}


def save(
    state: TrainState, save_dir: str, ts: Optional[int] = None,
    err_store=None,
) -> str:
    """Write the full TrainState; returns the path.

    ``err_store`` (the highest-error resampling distribution, BASELINE
    config 5) is part of the training trajectory: it rides along as an
    ``.err.npy`` sidecar so resume doesn't reset the error distribution.
    """
    os.makedirs(save_dir, exist_ok=True)
    host_state = jax.device_get(state)
    # multi-scene states carry a stacked (n_scenes,) step vector — all
    # scenes advance in lockstep, so any entry names the checkpoint
    step = int(np.asarray(host_state.step).reshape(-1)[0])
    path = checkpoint_path(save_dir, step, ts)
    arrays = {}
    for name in TrainState._fields:
        arrays.update(_flatten(name, getattr(host_state, name)))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # atomic: no torn checkpoints on preemption
    if err_store is not None:
        err_path = path.replace(".npz", ".err.npy")
        np.save(err_path + ".tmp.npy", jax.device_get(err_store))
        os.replace(err_path + ".tmp.npy", err_path)
    return path


def load_err_store(ckpt_path: str):
    """The error-resampling sidecar saved next to ``ckpt_path``, or
    None when the checkpoint predates error resampling."""
    err_path = ckpt_path.replace(".npz", ".err.npy")
    if not os.path.exists(err_path):
        return None
    return np.load(err_path)


def restore(path: str, template: TrainState) -> TrainState:
    """Load into the structure of ``template`` (a freshly-initialized
    state for the same Config).

    A field the checkpoint does not carry (saved as None, e.g. resuming
    a pre-EMA run with --ema_decay) starts from the template's value.
    """
    arrays = _load(path)
    present = _fields_in(arrays)
    return TrainState(*(
        _unflatten(name, getattr(template, name), arrays, path)
        if name in present else getattr(template, name)
        for name in TrainState._fields
    ))


def restore_weights(path: str, template: TrainState) -> TrainState:
    """Load params/fine_params/grid/step but keep the template's
    optimizer state.

    Eval and render don't optimize, but ``restore`` needs the template's
    opt_state pytree to match the checkpoint's — which encodes training
    hyperparameters (an lr SCHEDULE adds a count leaf that a
    constant-lr template lacks). Weight-only restore decouples
    inference from how the run was optimized.
    """
    arrays = _load(path)
    present = _fields_in(arrays)

    def _field(name, tpl):
        if tpl is None or name not in present:
            if tpl is None and name in present:
                # e.g. an occ-trained checkpoint evaluated without
                # --occ_res: the grid silently dropping means uniform
                # render sampling, which misses thin surfaces — make the
                # mismatch loud
                warnings.warn(
                    f"checkpoint {path} carries '{name}' but the eval "
                    f"config has none — it will be IGNORED. Pass the "
                    f"matching flags (--occ_res / --num_fine_samples / "
                    f"--use_proposal) or quality will silently collapse."
                )
            return tpl
        return _unflatten(name, tpl, arrays, path)

    # EMA weights (cfg.train.ema_decay > 0 during training) should be
    # restored for inference even when the eval config doesn't mention
    # EMA: the template pytree is built from the params structure (a
    # (params, second net) tuple when the checkpoint trained one, whose
    # leaves are stored under "ema/[0]..." and "ema/[1]...").
    if "ema" in present and template.ema is None:
        two = any(n.startswith("ema/[1]") for n in arrays)
        tpl = (template.params, template.fine_params) if two else template.params
        ema = _unflatten("ema", tpl, arrays, path)
    else:
        ema = _field("ema", template.ema)

    return template._replace(
        step=_field("step", template.step),
        params=_field("params", template.params),
        fine_params=_field("fine_params", template.fine_params),
        grid=_field("grid", template.grid),
        ema=ema,
    )


def latest_checkpoint(save_dir: str) -> Optional[str]:
    """Most recent checkpoint by (timestamp, step), or None."""
    if not os.path.isdir(save_dir):
        return None
    best = None
    for name in os.listdir(save_dir):
        m = _CKPT_RE.search(name)
        if m:
            key = (int(m.group(1)), int(m.group(2)))
            if best is None or key > best[0]:
                best = (key, os.path.join(save_dir, name))
    return best[1] if best else None
