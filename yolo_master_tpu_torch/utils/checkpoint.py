"""Checkpoints of the port (counterpart of ``yolo_master_tpu/utils/checkpoint.py``).

* Weights: ``.npz`` files of a model's state_dict by its ultralytics names
  (``best.npz``, ``last.npz``, ``healthy.npz``), with ``__meta__.<key>``
  string entries (``model``: the graph's name, or its config dict as JSON).
  :func:`load_weights_npz` also reads the JAX package's ``save_params_npz``
  files (dotted parameter-tree keys, ``__empty__`` markers), through
  :func:`unflatten_tree` and ``utils/weights.py:state_dict_from_jax``.
* The resume checkpoint: a directory (``state/``) holding one ``torch.save``
  of CPU tensors: the model's state_dict (parameters and BatchNorm buffers),
  the optimizer's count and buffers, the EMA, ``step``, ``ema_updates`` and
  ``aux_ema``. Loading it back is bitwise. The JAX package writes this
  state with orbax; the port needs no orbax.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_EMPTY = "__empty__"  # the JAX package's marker of a parameterless subtree
_META = "__meta__."
_STATE_FILE = "train_state.pt"


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Dotted keys -> nested dicts (the JAX package's ``unflatten_tree``)."""
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        node = tree
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if parts[-1] == _EMPTY:
            continue  # the setdefault chain already made the empty dict
        node[parts[-1]] = val
    return tree


def save_weights_npz(weights: Dict[str, torch.Tensor], path, metadata: Optional[Dict[str, str]] = None) -> str:
    """A state_dict (any device) as an ``.npz`` of its names, with ``__meta__.`` entries."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    flat = {k: v.detach().cpu().numpy() for k, v in weights.items()}
    meta = {f"{_META}{k}": np.asarray(str(v)) for k, v in (metadata or {}).items()}
    np.savez(path, **flat, **meta)
    return str(path)


def load_weights_npz(path) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    """(state_dict, metadata) of a weights file: the port's, or the JAX package's
    ``save_params_npz`` (its parameter tree mapped to the port's names)."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files if not k.startswith(_META)}
        meta = {k[len(_META):]: str(data[k]) for k in data.files if k.startswith(_META)}
    if any(k.split(".", 1)[0] == "layers" for k in flat):  # the JAX package's tree
        from .weights import state_dict_from_jax

        return state_dict_from_jax(unflatten_tree(flat)), meta
    return {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}, meta


def model_ref(cfg) -> str:
    """What ``__meta__.model`` holds: a graph's name, or its config dict as JSON."""
    return json.dumps(cfg) if isinstance(cfg, dict) else str(cfg)


def model_from_ref(ref: str):
    return json.loads(ref) if ref.startswith("{") else ref


# -- the resume checkpoint ---------------------------------------------------------------------

def snapshot(state) -> Dict[str, Any]:
    """Clones of everything a TrainState carries (``engine/train_step.py``), the
    model's parameters and BatchNorm buffers included, on their devices."""
    return {
        "model": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
        "opt_count": int(state.opt_state.count),
        "opt_buffers": {kind: {n: t.detach().clone() for n, t in bufs.items()}
                        for kind, bufs in state.opt_state.buffers.items()},
        "ema": {k: v.detach().clone() for k, v in state.ema_params.items()},
        "step": int(state.step),
        "ema_updates": float(state.ema_updates),
        "aux_ema": state.aux_ema.detach().clone(),
    }


@torch.no_grad()
def restore(state, snap: Dict[str, Any]):
    """Copy a :func:`snapshot` (any device) into ``state`` and its model in place; returns ``state``."""
    sd = state.model.state_dict()
    if set(sd) != set(snap["model"]):
        raise ValueError(f"the checkpoint's model entries differ: {sorted(set(sd) ^ set(snap['model']))[:5]}")
    for k, v in sd.items():
        v.copy_(snap["model"][k])
    for kind, bufs in state.opt_state.buffers.items():
        for n, t in bufs.items():
            t.copy_(snap["opt_buffers"][kind][n])
    for k, v in state.ema_params.items():
        v.copy_(snap["ema"][k])
    state.opt_state.count = snap["opt_count"]
    state.step = snap["step"]
    state.ema_updates = snap["ema_updates"]
    state.aux_ema = snap["aux_ema"].to(state.aux_ema.device, copy=True)
    return state


def save_train_state(state, path) -> str:
    """The resume checkpoint: ``path/train_state.pt`` (written whole, then renamed)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    snap = snapshot(state)
    cpu = {k: ({n: t.cpu() for n, t in v.items()} if k in ("model", "ema") else v) for k, v in snap.items()}
    cpu["opt_buffers"] = {kind: {n: t.cpu() for n, t in bufs.items()} for kind, bufs in snap["opt_buffers"].items()}
    cpu["aux_ema"] = snap["aux_ema"].cpu()
    tmp = path / f"{_STATE_FILE}.tmp"
    torch.save(cpu, tmp)
    os.replace(tmp, path / _STATE_FILE)
    return str(path)


def load_train_state(path, state):
    """Read :func:`save_train_state`'s checkpoint into ``state`` (same graph and optimizer kind), bitwise."""
    snap = torch.load(Path(path) / _STATE_FILE, map_location="cpu", weights_only=True)
    return restore(state, snap)
