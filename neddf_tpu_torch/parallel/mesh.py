"""Data parallelism over ranks: the ``data`` axis of the JAX package's mesh.

Counterpart of ``neddf_tpu/parallel/mesh.py`` for ``model == 1``, the
regime of every shipped config (``mesh: {data: auto, model: 1}``). The
JAX package shards the ray batch over a ``(data, model)`` device mesh
with ``shard_map`` and lets XLA insert the ``pmean`` of the gradients and
the ``all_gather`` of the eval tiles; here each card is one process (a
rank) and those two collectives are ``torch.distributed`` calls outside
the kernels, NCCL on the cards and gloo on the CPU:

* ``resolve_world`` reads the ``mesh`` config (the JAX trainer's
  ``_resolve_mesh``, ``neddf_tpu/training/trainer.py:263-287``): the
  number of ranks an entry point starts, or None for the single-process
  path; ``group_world`` is the world of a trainer, that of the process
  group it is built in (the trainer starts no ranks);
* ``init_rank`` joins a rank to its process group on its own card
  (``cuda:local_rank``, made the current device before anything is
  launched: the kernels launch on the current device), ``launch`` starts
  the ranks of a command on this host (``torch.multiprocessing``, spawn;
  a rank that fails ends the others and raises here);
* ``make_sharded_grads`` (``mesh.py:120-207``): every rank draws the
  whole global batch from the same generator state and keeps its rows
  ``[r B/n, (r+1) B/n)`` (``training/step.py::rank_rows``), runs the
  local step through the kernels, and one flat ``all_reduce`` divided by
  n averages every gradient, the camera-delta gradient and the step's
  metrics (JAX's pmeans of ``grads``, ``grads_cam``, ``loss``,
  ``loss_dict`` and ``mse``);
* ``make_sharded_render`` (``mesh.py:256-300``): each rank renders its
  contiguous rows of an eval chunk and the tiles are all-gathered in
  rank order, so every rank holds the whole image.

Width-sharded tensor parallelism (``model > 1``) is not ported: the JAX
package runs it through its jnp layer loops with an all-gather after
every layer (``tp_renderer``, ``fields/base.py::tp_gather``), and the
port's kernels fuse whole trunks, which cannot take width shards.
"""
from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from neddf_tpu_torch.render.renderer import ChunkRender

Tensor = torch.Tensor

#: the ``data`` values that mean every visible card (JAX: every device)
AUTO = ("auto", "max", None, -1)


def mesh_data(mesh_cfg: Optional[Dict[str, Any]]) -> Optional[int]:
    """The explicit ``data`` of a ``mesh`` config, or None for every card
    (``AUTO``, or no mesh config). ``model > 1`` raises
    NotImplementedError."""
    mesh_cfg = mesh_cfg or {}
    model = int(mesh_cfg.get("model", 1) or 1)
    if model > 1:
        raise NotImplementedError(
            f"mesh model={model}: width-sharded tensor parallelism is not ported "
            "(ROADMAP.md, the TP item of Queue 1: the port's kernels fuse whole trunks)")
    data = mesh_cfg.get("data", "auto")
    if data in AUTO:
        return None
    if int(data) < 1:
        raise ValueError(f"mesh data={data} must be at least 1")
    return int(data)


def resolve_world(
    mesh_cfg: Optional[Dict[str, Any]],
    device_type: str,
    n_cards: int,
    launched: Optional[int] = None,
    local_ranks: Optional[int] = None,
) -> Optional[int]:
    """The number of data-parallel ranks that an entry point runs for a
    ``mesh`` config, or None for the single-process path (a world of 1,
    or no mesh config and no launcher).

    ``data: auto`` (also ``max``, ``None``, ``-1``; a missing mesh config
    under a launcher) is the world a launcher made (``launched``,
    torchrun's ``WORLD_SIZE``), else every one of the ``n_cards`` visible
    cards on CUDA, and 1 on the CPU. An explicit ``data`` is taken as it
    is. On CUDA each rank of this host needs a card of its own: the ranks
    here are ``local_ranks`` (torchrun's ``LOCAL_WORLD_SIZE``) under a
    launcher, else all of them. ``model > 1`` raises
    NotImplementedError."""
    if not mesh_cfg and launched is None:
        return None
    data = mesh_data(mesh_cfg)
    if data is None:
        if launched is not None:
            data = launched
        else:
            data = max(1, n_cards) if device_type == "cuda" else 1
    if launched is not None and data != launched:
        raise ValueError(f"mesh data={data}, but the launcher started {launched} ranks")
    if data == 1:
        return None
    here = data if launched is None or local_ranks is None else local_ranks
    if device_type == "cuda" and here > n_cards:
        raise ValueError(
            f"mesh {data}x1 needs {here} devices{'' if launched is None else ' on this host'}; "
            f"platform 'cuda' has {n_cards}")
    return data


def group_world(mesh_cfg: Optional[Dict[str, Any]]) -> Optional[int]:
    """The data-parallel world of a trainer built in this process: the
    size of the default process group it is in (one process when there is
    none), or None for the single-process path. An explicit ``data`` must
    be that size: the entry point that starts the ranks decides how many
    (``resolve_world``), not the trainer. ``model > 1`` raises
    NotImplementedError."""
    data = mesh_data(mesh_cfg)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data is not None and data != world:
        raise RuntimeError(
            f"mesh data={data}: build the trainer in each rank of a process group of "
            f"{data} (python -m neddf_tpu_torch.scripts.run starts them, or torchrun); "
            f"this process is in a group of {world}")
    return world if world > 1 else None


class Launched(NamedTuple):
    """A process that a launcher such as torchrun started: its rank and
    world, and its rank and the number of ranks on its own host."""

    rank: int
    world: int
    local_rank: int
    local_world: int


def launcher_world() -> Optional[Launched]:
    """The ranks of a process that a launcher started (``RANK`` and
    ``WORLD_SIZE`` set; ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` default
    to one host), else None."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return Launched(rank, world, int(os.environ.get("LOCAL_RANK", rank)),
                    int(os.environ.get("LOCAL_WORLD_SIZE", world)))


def local_device(device_type: str) -> torch.device:
    """This rank's device: the current card (``init_rank`` made it its
    own), or the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def init_rank(rank: int, world: int, device_type: str, init_method: str,
              local_rank: Optional[int] = None) -> torch.device:
    """Join the default process group as ``rank`` of ``world`` (NCCL on
    CUDA, gloo on the CPU) through ``init_method`` (``file://`` or
    ``tcp://localhost:<port>``, or ``env://`` under a launcher); on CUDA
    first make ``cuda:local_rank`` (the rank on this host; default
    ``rank``, the ranks that ``launch`` starts share one host) the
    current device. Returns the rank's device."""
    if device_type == "cuda":
        index = rank if local_rank is None else local_rank
        if index >= torch.cuda.device_count():
            raise ValueError(f"rank {rank} needs cuda:{index}; "
                             f"{torch.cuda.device_count()} cards are visible")
        torch.cuda.set_device(index)
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    return local_device(device_type)


def _rank_main(rank: int, world: int, device_type: str, init_method: str,
               fn: Callable[..., Any], args: Sequence[Any],
               local_rank: Optional[int] = None) -> None:
    init_rank(rank, world, device_type, init_method, local_rank)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable[..., Any], args: Sequence[Any], world: int, device_type: str,
           rendezvous_dir: "str | Path") -> None:
    """Run ``fn(*args)`` on ``world`` ranks on this host, one process each
    (spawned: ``fn`` and ``args`` are pickled), every rank in the default
    process group. The rendezvous is a fresh ``file://`` store under
    ``rendezvous_dir``, so concurrent launches never share one. On CUDA
    the kernels are built here first, once, not by every rank. A rank
    that raises or dies ends the others, and this call raises."""
    if device_type == "cuda":
        from neddf_tpu_torch.kernels import _build

        _build.build()
    store = Path(rendezvous_dir).resolve() / f".rendezvous-{os.getpid()}-{time.time_ns()}"
    try:
        torch.multiprocessing.spawn(
            _rank_main, args=(world, device_type, f"file://{store}", fn, tuple(args)),
            nprocs=world, join=True)
    finally:
        store.unlink(missing_ok=True)


def run_world(fn: Callable[..., Any], args: Sequence[Any], world: Optional[int],
              device_type: str, rendezvous_dir: "str | Path") -> Any:
    """Run ``fn(*args)``: in this process alone when ``world`` is None
    (returning its result), as this process's rank of a launcher's
    process group (torchrun: ``env://``, on the card of its
    ``LOCAL_RANK``), or over ``world`` ranks that this call starts
    (``launch``)."""
    if world is None:
        return fn(*args)
    launched = launcher_world()
    if launched is None:
        launch(fn, args, world, device_type, rendezvous_dir)
    else:
        _rank_main(launched.rank, world, device_type, "env://", fn, args, launched.local_rank)
    return None


def world_and_rank(group: Optional[Any] = None) -> Tuple[int, int]:
    """(world size, rank) in ``group`` (default: the default group)."""
    return dist.get_world_size(group), dist.get_rank(group)


def check_world_batch(batch_size: int, world: int) -> int:
    """The per-rank batch; ``batch_size`` must split evenly over the
    ranks (the JAX trainer's check and text)."""
    if batch_size % world:
        raise ValueError(f"batch_size={batch_size} not divisible by mesh data axis {world}")
    return batch_size // world


def make_sharded_grads(group: Optional[Any], batch_size: int, grad_accum: int = 1):
    """The data-parallel step over the ranks of ``group`` (any process
    group; None is the default one).

    Returns ``grads_fn(local_grads, params, camera_deltas=None) -> (loss,
    loss_dict, mse)``. ``local_grads(rows)`` runs the step's math on the
    rows ``rows`` (a slice) of the whole drawn batch, leaving its
    gradients in ``.grad`` and returning its (loss, loss dict, mse)
    (``training/trainer.py::NeRFTrainer.local_grads``, over
    ``step.py::accumulate_grads``). ``grads_fn`` calls it on this rank's
    rows, then reduces, in one flat ``all_reduce`` divided by the world
    size, the ``.grad`` of every parameter in ``params`` that has one, the
    ``.grad`` of ``camera_deltas`` and the metrics, and writes the means
    back. Every rank ends with the same gradients and metrics."""
    # importing training.step runs training/__init__.py, which imports the
    # trainer, which imports this module
    from neddf_tpu_torch.training.step import check_local_grad_accum, rank_rows

    world, rank = world_and_rank(group)
    local_batch = check_world_batch(batch_size, world)
    check_local_grad_accum(grad_accum, local_batch, batch_size)
    rows = rank_rows(batch_size, rank, world)

    def grads_fn(local_grads: Callable[[slice], Tuple[Tensor, Dict[str, Tensor], Tensor]],
                 params: Sequence[Tensor], camera_deltas: Optional[Tensor] = None):
        loss, loss_dict, mse = local_grads(rows)
        grads = [p.grad for p in params if p.grad is not None]
        if camera_deltas is not None and camera_deltas.grad is not None:
            grads.append(camera_deltas.grad)
        metrics = torch.stack([loss, mse, *loss_dict.values()]).float()
        flat = torch.cat([g.reshape(-1).float() for g in grads] + [metrics])
        dist.all_reduce(flat, group=group)
        flat.div_(world)
        at = 0
        for g in grads:
            g.copy_(flat[at : at + g.numel()].view_as(g))
            at += g.numel()
        means = flat[at:]
        return means[0], dict(zip(loss_dict, means[2:])), means[1]

    return grads_fn


def make_sharded_render(group: Optional[Any] = None) -> Callable[[ChunkRender], ChunkRender]:
    """The eval render over the ranks of ``group`` (the JAX package's
    sharded ``render_fn``): returns ``shard(render) -> render'``, which
    wraps a per-chunk program ``render(uv, u_strat, u_pdf) -> {key: [B,
    ...]}`` (``render/renderer.py::render_image``'s). Every rank passes the
    whole chunk with its draws; ``render'`` pads it by repeating its last
    row to a multiple of the world size, renders this rank's contiguous
    rows, and all-gathers every output in rank order, so each rank
    returns the whole chunk's."""
    world, rank = world_and_rank(group)

    def shard(render: ChunkRender) -> ChunkRender:
        def sharded(uv: Tensor, u_strat: Tensor, u_pdf: Tensor) -> Dict[str, Tensor]:
            n = uv.shape[0]
            per = -(-n // world)
            pad = per * world - n
            mine = slice(rank * per, (rank + 1) * per)
            local = [torch.cat([x, x[-1:].expand(pad, *x.shape[1:])]) if pad else x
                     for x in (uv, u_strat, u_pdf)]
            out = render(*(x[mine] for x in local))
            whole = {}
            for k, v in out.items():
                parts = [torch.empty_like(v) for _ in range(world)]
                dist.all_gather(parts, v.contiguous(), group=group)
                whole[k] = torch.cat(parts)[:n]
            return whole

        return sharded

    return shard


def broadcast_parameters(module: torch.nn.Module, group: Optional[Any] = None,
                         src: int = 0) -> None:
    """Make every rank's parameters rank ``src``'s (one flat broadcast)."""
    params = list(module.parameters())
    flat = torch.cat([p.detach().reshape(-1).float() for p in params])
    dist.broadcast(flat, src=src, group=group)
    at = 0
    with torch.no_grad():
        for p in params:
            p.copy_(flat[at : at + p.numel()].view_as(p))
            at += p.numel()
