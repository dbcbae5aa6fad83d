"""Checkpoints: flax msgpack params <-> a PyTorch state_dict.

``params_from_jax`` is the one carry-over from the JAX parameter tree
(``{"network_fine": {"layers_ddf": [{"w", "b"}, ...], ...}}``, lists
either as lists or as the ``"0"``, ``"1"``, ... maps that a msgpack
restore gives) to this package's module names
(``network_fine.layers_ddf.0.w``). Both layouts store weights
``[in, out]``, so no tensor is transposed. The tests and the trainer's
loader share it; ``params_to_jax`` is its inverse, which
``NeRFTrainer.save_checkpoint`` writes in the flax layout.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Union

import numpy as np
import torch

from neddf_tpu_torch.utils.msgpack import load_msgpack


def load_msgpack_params(path: Union[str, Path]) -> Dict[str, Any]:
    """The parameter tree of a flax msgpack checkpoint (its ``params``
    entry for a full training state, else the whole tree)."""
    state = load_msgpack(path)
    if not isinstance(state, dict):
        raise ValueError(f"{path}: checkpoint is not a map")
    return state["params"] if "params" in state else state


def params_from_jax(tree: Any) -> Dict[str, torch.Tensor]:
    """Flatten a JAX parameter tree of numpy arrays into a state_dict."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Any, prefix: str) -> None:
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            out[prefix] = torch.from_numpy(np.array(node, dtype=np.float32))
            return
        for key, child in items:
            walk(child, f"{prefix}.{key}" if prefix else str(key))

    walk(tree, "")
    return out


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Nest a state_dict into the JAX parameter tree of numpy f32 arrays,
    lists as ``"0"``, ``"1"``, ... maps (flax's ``to_state_dict``)."""
    tree: Dict[str, Any] = {}
    for name, tensor in state_dict.items():
        node = tree
        *parents, leaf = name.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = tensor.detach().float().cpu().numpy()
    return tree
