"""Checkpoints: the training state in the flax msgpack layout, and the
reference's ``.pth``.

``params_from_jax`` is the one carry-over from the JAX parameter tree
(``{"network_fine": {"layers_ddf": [{"w", "b"}, ...], ...}}``, lists
either as lists or as the ``"0"``, ``"1"``, ... maps that a msgpack
restore gives) to this package's module names
(``network_fine.layers_ddf.0.w``). Both layouts store weights
``[in, out]``, so no tensor is transposed. The tests and the trainer's
loader share it; ``params_to_jax`` is its inverse.

A checkpoint (``NeRFTrainer.save_checkpoint``) is the map that the JAX
trainer's ``_state_dict`` (``neddf_tpu/training/trainer.py:670``) writes,
less its ``key``: ``params``, ``iteration``, ``camera_deltas``,
``opt_state`` in optax's layout (``adam_to_optax``: torch Adam's
``exp_avg``, ``exp_avg_sq`` and ``step`` are ``mu``, ``nu`` and
``count``), ``opt_state_cam`` as ``RowSparseAdamState`` (``m``, ``v``,
``t``), and ``torch_rng``: the trainer's generator state and its device
type (``jax.random`` and torch draw different streams, so neither
package's key or state serves the other). Writes are atomic
(``utils/msgpack.py::save_msgpack``); ``AsyncCheckpointer`` writes them
from a thread.

The reference's ``.pth`` (``export_pth`` / ``state_dict_from_pth``):
``neddf``'s ``NeRFRender.state_dict()`` keys. Each network names its own
(``pth_name``) and says whether its weights are transposed
(``pth_linear_transposed``: ``LinearGradLayer`` weights (NeDDF) stay
``[in, out]``, ``nn.Linear`` weights (NeRF, NeuS) are ``[out, in]``). A
renderer that shares one network holds it under both prefixes
(``neddf_tpu/training/checkpoint.py:98-248``).
"""
from __future__ import annotations

import concurrent.futures
import os
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from neddf_tpu_torch.utils.msgpack import load_msgpack, save_msgpack


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


def adam_moments(optimizer: torch.optim.Adam, named_params: List[Tuple[str, torch.Tensor]]):
    """torch Adam's (step count, first moments, second moments) by
    parameter name (zeros before a parameter's first step). Every
    parameter takes one step per update, so the count is their ``step``."""
    count = 0
    mu, nu = {}, {}
    for name, p in named_params:
        state = optimizer.state.get(p, {})
        if state:
            count = max(count, int(state["step"]))
            mu[name], nu[name] = state["exp_avg"], state["exp_avg_sq"]
        else:
            mu[name], nu[name] = torch.zeros_like(p), torch.zeros_like(p)
    return count, mu, nu


def optax_adam_tree(count: int, mu: Dict[str, torch.Tensor], nu: Dict[str, torch.Tensor],
                    decayed: bool) -> Dict[str, Any]:
    """Adam's count and moments as the JAX trainer's optax chain state:
    ``[add_decayed_weights (when decayed),] scale_by_adam,
    scale_by_learning_rate``, lists as ``"0"``, ``"1"``, ... maps; the
    schedule's count is Adam's."""
    chain = [{}] if decayed else []
    chain += [{"count": np.asarray(count, np.int32), "mu": params_to_jax(mu),
               "nu": params_to_jax(nu)},
              {"count": np.asarray(count, np.int32)}]
    return {str(i): s for i, s in enumerate(chain)}


def adam_to_optax(optimizer: torch.optim.Adam, named_params: List[Tuple[str, torch.Tensor]],
                  decayed: bool) -> Dict[str, Any]:
    """torch Adam's state as the JAX trainer's optax chain state
    (``adam_moments``, ``optax_adam_tree``)."""
    return optax_adam_tree(*adam_moments(optimizer, named_params), decayed)


def adam_from_optax(tree: Dict[str, Any], optimizer: torch.optim.Adam,
                    named_params: List[Tuple[str, torch.Tensor]],
                    local: Optional[Callable[[Dict[str, torch.Tensor]],
                                             Dict[str, torch.Tensor]]] = None) -> None:
    """Set torch Adam's state from an optax chain state (either package's
    checkpoint): the entry that holds ``mu``, whatever its chain index;
    ``local`` maps the full moments to the parameters' own (a rank's width
    shards under tensor parallelism)."""
    adams = [s for s in tree.values() if isinstance(s, dict) and "mu" in s]
    if len(adams) != 1:
        raise ValueError(f"opt_state: expected one scale_by_adam state, found {len(adams)}")
    adam = adams[0]
    count = int(np.asarray(adam["count"]))
    mu, nu = params_from_jax(adam["mu"]), params_from_jax(adam["nu"])
    if local is not None:
        mu, nu = local(mu), local(nu)
    names = {name for name, _ in named_params}
    if set(mu) != names or set(nu) != names:
        raise ValueError(f"opt_state does not match the parameters: missing "
                         f"{sorted(names - set(mu))}, extra {sorted(set(mu) - names)}")
    for name, p in named_params:
        if tuple(mu[name].shape) != tuple(p.shape) or tuple(nu[name].shape) != tuple(p.shape):
            raise ValueError(f"opt_state {name}: shape {tuple(mu[name].shape)}, "
                             f"parameter {tuple(p.shape)}")
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu[name].to(p.device),
            "exp_avg_sq": nu[name].to(p.device),
        }


def row_sparse_to_tree(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """``RowSparseAdam``'s state of the camera deltas as ``RowSparseAdamState``."""
    return {"m": state["m"].cpu().numpy(), "v": state["v"].cpu().numpy(),
            "t": state["t"].cpu().numpy().astype(np.int32)}


def row_sparse_from_tree(tree: Dict[str, Any], deltas: torch.Tensor) -> Dict[str, torch.Tensor]:
    # copies: a decoded checkpoint's arrays are read-only views of its bytes
    out = {"m": torch.tensor(np.array(tree["m"], np.float32), device=deltas.device),
           "v": torch.tensor(np.array(tree["v"], np.float32), device=deltas.device),
           "t": torch.tensor(np.array(tree["t"], np.int32), device=deltas.device)}
    if out["m"].shape != deltas.shape or out["t"].shape != deltas.shape[:1]:
        raise ValueError(f"opt_state_cam shapes {tuple(out['m'].shape)}, "
                         f"{tuple(out['t'].shape)} for deltas {tuple(deltas.shape)}")
    return out


class AsyncCheckpointer:
    """Checkpoint writes in a background thread, in the order given.

    ``save`` takes a state already copied to host numpy arrays (the
    trainer copies it at once, so training may go on changing its
    tensors) and returns; one worker thread encodes and writes it
    atomically to the same file a synchronous save writes. ``wait``
    blocks until every write is on disk and raises the first error.
    """

    def __init__(self) -> None:
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: List[concurrent.futures.Future] = []

    def save(self, path: Union[str, Path], state: Dict[str, Any]) -> None:
        self._pending.append(self._pool.submit(save_msgpack, path, state))

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for future in pending:
            future.result()


# ------------------------------------------------------- the reference .pth
def pth_layout(renderer: Any) -> Dict[str, Tuple[str, bool]]:
    """Reference ``.pth`` key -> (this package's parameter name, whether
    the tensor is transposed between them). Each network states its own
    layout: ``pth_name(name)`` and ``pth_linear_transposed``."""
    fine = renderer.network_fine
    nets = [("network_fine", "network_fine", fine)]
    if renderer.use_coarse_network:
        nets.append(("network_coarse", "network_coarse", renderer.network_coarse))
    else:
        nets.append(("network_coarse", "network_fine", fine))
    layout = {}
    for pth_prefix, prefix, net in nets:
        for name, t in net.state_dict().items():
            transpose = net.pth_linear_transposed and name.endswith(".w") and t.ndim == 2
            layout[f"{pth_prefix}.{net.pth_name(name)}"] = (f"{prefix}.{name}", transpose)
    return layout


def export_pth(renderer: Any, path: Union[str, Path]) -> None:
    """Write the renderer's parameters as a reference-layout ``.pth``
    (atomically: a temporary file in the same directory, then a rename)."""
    params = renderer.state_dict()
    sd = {}
    for key, (name, transpose) in pth_layout(renderer).items():
        t = params[name].detach().float().cpu()
        sd[key] = (t.T if transpose else t).contiguous().clone()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(sd, str(tmp))
    os.replace(tmp, path)


def state_dict_from_pth(path: Union[str, Path], renderer: Any) -> Dict[str, torch.Tensor]:
    """This package's state_dict from a reference-layout ``.pth``; any
    missing or extra key raises (a shared network's ``network_coarse``
    copies must be there, and its ``network_fine`` ones are loaded)."""
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    layout = pth_layout(renderer)
    missing, extra = sorted(set(layout) - set(sd)), sorted(set(sd) - set(layout))
    if missing or extra:
        raise ValueError(f"{path}: keys do not match the renderer: missing {missing}, "
                         f"extra {extra}")
    shapes = {name: tuple(t.shape) for name, t in renderer.state_dict().items()}
    out: Dict[str, torch.Tensor] = {}
    for key, (name, transpose) in layout.items():
        if name in out and key.startswith("network_coarse."):
            continue
        t = sd[key].float()
        t = t.T if transpose else t
        if t.numel() != int(np.prod(shapes[name])):
            raise ValueError(f"{path}: {key} has shape {tuple(sd[key].shape)}, the "
                             f"renderer's {name} {shapes[name]}")
        # the JAX package's exporter writes NeuS's scalar variance as [1]
        out[name] = t.reshape(shapes[name]).contiguous()
    return out
