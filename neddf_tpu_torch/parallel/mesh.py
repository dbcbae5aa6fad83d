"""Parallelism over ranks: the ``(data, model)`` mesh of the JAX package.

Counterpart of ``neddf_tpu/parallel/mesh.py``. The JAX package shards
the ray batch over the ``data`` axis of a ``(data, model)`` device mesh
and the trunks' widths over its ``model`` axis, with ``shard_map``; here
each card is one process (a rank) and the collectives are
``torch.distributed`` calls outside the kernels, NCCL on the cards and
gloo on the CPU:

* ``resolve_world`` reads the ``mesh`` config (the JAX trainer's
  ``_resolve_mesh``, ``neddf_tpu/training/trainer.py:263-287``): the
  number of ranks an entry point starts, ``data x model`` (``data:
  auto`` is the cards divided by ``model``, 1 on the CPU), or None for the
  single-process path; ``group_world`` is the world of a trainer, that of
  the process group it is built in (the trainer starts no ranks);
* ``init_rank`` joins a rank to its process group on its own card
  (``cuda:local_rank``, made the current device before anything is
  launched: the kernels launch on the current device), ``launch`` starts
  the ranks of a command on this host (``torch.multiprocessing``, spawn;
  a rank that fails ends the others and raises here);
* ``make_mesh``: rank r is ``(r // model, r % model)`` in the row-major
  ``(data, model)`` mesh (``mesh.py:26-40``); every rank builds every
  data group (the ranks of one model index) and every model group (the
  ranks of one data index) in one order;
* ``field_param_specs`` / ``shard_parameters`` (``mesh.py:57-73``): a 2-D
  weight shards its out-dimension and a 1-D bias its length over the
  model group when ``model`` divides them; the rest replicates (the 1-
  and 3-wide heads, NeuS's 3-wide colour output). ``gather_state`` puts
  the shards back together;
* ``make_sharded_grads`` (``mesh.py:120-207``): every rank draws the
  whole global batch from the same generator state and keeps its data
  group's rows ``[d B/D, (d+1) B/D)`` (``training/step.py::rank_rows``),
  runs the local step through the kernels (under ``model > 1`` over the
  fields' width shards, ``parallel/tp.py``), divides the sharded leaves'
  gradients by ``model`` (every model rank computes the same loss, and
  the gathers' backward sums their cotangents), averages the gradients
  and metrics over the data group and the camera-delta gradient over
  every rank (JAX's pmeans of ``grads`` over ``data``, of ``grads_cam``
  over ``data`` and ``model``);
* ``make_sharded_render`` (``mesh.py:256-336``): each rank of a data
  group renders its contiguous rows of an eval chunk (the ranks of one
  model group the same rows, through the width shards) and the tiles
  are all-gathered in rank order, so every rank holds the whole image.
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



def mesh_shape(mesh_cfg: Optional[Dict[str, Any]]) -> Tuple[Optional[int], int]:
    """(the explicit ``data`` of a ``mesh`` config or None for ``AUTO`` /
    no mesh config, its ``model``)."""
    mesh_cfg = mesh_cfg or {}
    model = int(mesh_cfg.get("model", 1) or 1)
    if model < 1:
        raise ValueError(f"mesh model={model} must be at least 1")
    data = mesh_cfg.get("data", "auto")
    if data in AUTO:
        return None, model
    if int(data) < 1:
        raise ValueError(f"mesh data={data} must be at least 1")
    return int(data), model


def resolve_world(
    mesh_cfg: Optional[Dict[str, Any]],
    device_type: str,
    n_cards: int,
    launched: Optional[int] = None,
    local_ranks: Optional[int] = None,
) -> Optional[int]:
    """The number of ranks, ``data x model``, that an entry point runs for
    a ``mesh`` config, or None for the single-process path (a world of 1,
    or no mesh config and no launcher).

    ``data: auto`` (also ``max``, ``None``, ``-1``; a missing mesh config
    under a launcher) is the world a launcher made (``launched``,
    torchrun's ``WORLD_SIZE``) divided by ``model``, else the ``n_cards``
    visible cards divided by ``model`` on CUDA (at least 1), and 1 on the
    CPU. An explicit ``data`` is taken as it is. On CUDA each rank of this
    host needs a card of its own: the ranks here are ``local_ranks``
    (torchrun's ``LOCAL_WORLD_SIZE``) under a launcher, else all of
    them."""
    if not mesh_cfg and launched is None:
        return None
    data, model = mesh_shape(mesh_cfg)
    if data is None:
        if launched is not None:
            if launched % model:
                raise ValueError(f"the launcher started {launched} ranks, not a multiple of "
                                 f"mesh model={model}")
            data = launched // model
        else:
            data = max(1, n_cards // model) if device_type == "cuda" else 1
    world = data * model
    if launched is not None and world != launched:
        raise ValueError(f"mesh {data}x{model}, but the launcher started {launched} ranks")
    if world == 1:
        return None
    here = world if launched is None or local_ranks is None else local_ranks
    if device_type == "cuda" and here > n_cards:
        raise ValueError(
            f"mesh {data}x{model} needs {here} devices"
            f"{'' if launched is None else ' on this host'}; platform 'cuda' has {n_cards}")
    return world


def group_world(mesh_cfg: Optional[Dict[str, Any]]) -> Optional[int]:
    """The world of a trainer built in this process: the size of the
    default process group it is in (one process when there is none), or
    None for the single-process path. An explicit ``data`` times ``model``
    must be that size, and ``model`` must divide it: the entry point that
    starts the ranks decides how many (``resolve_world``), not the
    trainer."""
    data, model = mesh_shape(mesh_cfg)
    world = dist.get_world_size() if dist.is_initialized() else 1
    want = None if data is None else data * model
    if (want is not None and want != world) or world % model:
        raise RuntimeError(
            f"mesh {data or 'auto'}x{model}: build the trainer in each rank of a process "
            f"group of {want or f'a multiple of {model}'} (python -m "
            "neddf_tpu_torch.scripts.run starts them, or torchrun); this process is in a "
            f"group of {world}")
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
               local_rank: Optional[int] = None, threads: Optional[int] = None) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
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
    # CPU ranks share this host's cores (each would take them all, and the
    # ranks' idle threads spin while another computes between collectives)
    threads = max(1, (os.cpu_count() or 1) // world) if device_type == "cpu" else None
    try:
        torch.multiprocessing.spawn(
            _rank_main,
            args=(world, device_type, f"file://{store}", fn, tuple(args), None, threads),
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


class Mesh(NamedTuple):
    """This rank's place in the ``(data, model)`` mesh and its two groups:
    ``data_group`` (the ranks of its model index; None, the default group,
    when ``model`` is 1) and ``model_group`` (the ranks of its data index;
    None when ``model`` is 1)."""

    data: int
    model: int
    data_rank: int
    model_rank: int
    data_group: Any
    model_group: Any


def make_mesh(model: int) -> Mesh:
    """The mesh of the default process group with ``model`` ranks on the
    width axis: rank r is ``(r // model, r % model)``; every rank builds
    every group (``dist.new_group``), in one order."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % model:
        raise ValueError(f"{world} ranks not divisible by model={model}")
    data = world // model
    if model == 1:
        return Mesh(data, 1, rank, 0, None, None)
    data_groups = [dist.new_group([d * model + m for d in range(data)]) for m in range(model)]
    model_groups = [dist.new_group([d * model + m for m in range(model)]) for d in range(data)]
    d, m = divmod(rank, model)
    return Mesh(data, model, d, m, data_groups[m], model_groups[d])


def field_param_specs(shapes: Dict[str, Sequence[int]], model: int) -> Dict[str, tuple]:
    """The JAX package's ``field_param_specs`` over a state dict's shapes:
    per parameter, ``(None, "model")`` for a 2-D weight whose out-dimension
    ``model`` divides, ``("model",)`` for such a 1-D bias, else ``()``
    (replicated), the entries of its ``PartitionSpec``s."""
    out = {}
    for name, shape in shapes.items():
        shape = tuple(shape)
        if model > 1 and len(shape) == 2 and shape[1] % model == 0:
            out[name] = (None, "model")
        elif model > 1 and len(shape) == 1 and shape[0] % model == 0:
            out[name] = ("model",)
        else:
            out[name] = ()
    return out


def tp_shard_names(module: torch.nn.Module, model: int) -> set:
    """The parameters of a renderer that shard over ``model`` ranks (their
    last dimension), by ``field_param_specs`` of its full shapes: the
    weight and bias of every layer that its networks' ``column_shards()``
    name (the trunks; NeRF's colour head's first layer) must shard and
    nothing else may (a ``model`` that does not divide such a layer's
    width, or that divides a head's, raises ValueError)."""
    specs = field_param_specs({n: p.shape for n, p in module.named_parameters()}, model)
    names = {n for n, spec in specs.items() if spec}
    trunk = set()
    for prefix, net in module.named_modules():
        for layer in getattr(net, "column_shards", lambda: [])():
            trunk |= {".".join(filter(None, (prefix, layer, leaf))) for leaf in ("w", "b")}
    if names != trunk:
        raise ValueError(
            f"mesh model={model} must divide every trunk width and no head's: it would shard "
            f"{sorted(names - trunk)} and not {sorted(trunk - names)}")
    return names


def shard_tensor(full: Tensor, mesh: Mesh) -> Tensor:
    """This rank's columns (last dimension) of a full tensor."""
    per = full.shape[-1] // mesh.model
    return full[..., mesh.model_rank * per : (mesh.model_rank + 1) * per].contiguous()


def shard_parameters(module: torch.nn.Module, mesh: Mesh, names: set) -> None:
    """Keep only this rank's shard of each parameter in ``names`` (in
    place: the parameter objects stay, their data shrinks)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name in names:
                p.data = shard_tensor(p.data, mesh)


def gather_state(state: Dict[str, Tensor], mesh: Mesh, names: set) -> Dict[str, Tensor]:
    """The full tensors of a map of this rank's ones: those in ``names``
    all-gathered over the model group along their last dimension, the
    rest as they are. Every rank of the model group calls it."""
    from neddf_tpu_torch.parallel.tp import all_gather_last

    return {k: all_gather_last(v.detach(), mesh.model_group) if k in names else v
            for k, v in state.items()}


def make_sharded_grads(mesh: Optional[Mesh], batch_size: int, grad_accum: int = 1,
                       sharded: Sequence[Tensor] = ()):
    """The step over the ranks of ``mesh`` (None: data parallelism over
    the default process group).

    Returns ``grads_fn(local_grads, params, camera_deltas=None) -> (loss,
    loss_dict, mse)``. ``local_grads(rows)`` runs the step's math on the
    rows ``rows`` (a slice) of the whole drawn batch, leaving its
    gradients in ``.grad`` and returning its (loss, loss dict, mse)
    (``training/trainer.py::NeRFTrainer.local_grads``, over
    ``step.py::accumulate_grads``). ``grads_fn`` calls it on this rank's
    data rows, divides the gradients of the parameters in ``sharded`` (the
    width shards) by ``model``, then reduces, in one flat ``all_reduce``
    over the data group divided by its size, the ``.grad`` of every
    parameter in ``params`` that has one and the metrics, and the
    ``.grad`` of ``camera_deltas`` over every rank (with the rest where
    ``model`` is 1), and writes the means back. The ranks of a data group
    end with the same gradients, every rank with the same metrics and
    camera gradient."""
    # importing training.step runs training/__init__.py, which imports the
    # trainer, which imports this module
    from neddf_tpu_torch.training.step import check_local_grad_accum, rank_rows

    if mesh is None:
        world, rank = world_and_rank(None)
        mesh = Mesh(world, 1, rank, 0, None, None)
    local_batch = check_world_batch(batch_size, mesh.data)
    check_local_grad_accum(grad_accum, local_batch, batch_size)
    rows = rank_rows(batch_size, mesh.data_rank, mesh.data)
    shards = {id(p) for p in sharded}

    def mean(flat: Tensor, group: Any, n: int) -> None:
        if n > 1:
            dist.all_reduce(flat, group=group)
            flat.div_(n)

    def grads_fn(local_grads: Callable[[slice], Tuple[Tensor, Dict[str, Tensor], Tensor]],
                 params: Sequence[Tensor], camera_deltas: Optional[Tensor] = None):
        loss, loss_dict, mse = local_grads(rows)
        grads = [p.grad for p in params if p.grad is not None]
        if mesh.model > 1:
            for p in params:
                if id(p) in shards and p.grad is not None:
                    p.grad.div_(mesh.model)
        cam = None
        if camera_deltas is not None and camera_deltas.grad is not None:
            cam = camera_deltas.grad
            if mesh.model == 1:
                grads.append(cam)
        metrics = torch.stack([loss, mse, *loss_dict.values()]).float()
        flat = torch.cat([g.reshape(-1).float() for g in grads] + [metrics])
        mean(flat, mesh.data_group, mesh.data)
        at = 0
        for g in grads:
            g.copy_(flat[at : at + g.numel()].view_as(g))
            at += g.numel()
        if cam is not None and mesh.model > 1:
            total = cam.float().contiguous()
            mean(total, None, mesh.data * mesh.model)
            cam.copy_(total)
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
        if world == 1:  # a data group of one rank (data 1 under model > 1)
            return render

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
