"""Rank programs of the port's data-parallel tests (``test_torch_parallel.py``,
``test_torch_parallel_trainer.py``), run in a process of their own:

    python -m tests.torch_parallel_ranks <task> <inputs.pt> <outputs.pt> <world>

starts ``world`` gloo ranks on the CPU through the port's own launcher
(``neddf_tpu_torch.parallel.launch``); rank r writes ``<outputs>.rank{r}``.
Imports neither JAX nor the JAX package, so a rank starts in seconds; the
tests make the inputs (configs, weights, the JAX package's draws) and
compare the outputs.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch
import torch.distributed as dist

from neddf_tpu_torch import config as tconfig
from neddf_tpu_torch.geometry.camera import PinholeCalib
from neddf_tpu_torch.ops.occupancy import OccupancyGrid
from neddf_tpu_torch.parallel import launch, make_sharded_render
from neddf_tpu_torch.render.renderer import NeRFRender


def _threads() -> None:
    torch.set_num_threads(2)  # the ranks share the test run's cores


def _save(out: str, result) -> None:
    torch.save(result, f"{out}.rank{dist.get_rank()}")


def _trainer(cfg: dict, state=None):
    trainer = tconfig.instantiate(cfg["trainer"], global_config=cfg)
    if state is not None:
        trainer.neural_render.load_state_dict(
            {k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return trainer


def grads(inputs: dict, out: str) -> None:
    """One data-parallel step per case (``NeRFTrainer.step_grads`` over
    ``mesh.data`` = world) on the given draws: the loss, loss dict, mse,
    every parameter's gradient and the camera-delta gradient."""
    _threads()
    results = []
    for case in inputs["cases"]:
        trainer = _trainer(case["cfg"], case["state"])
        with torch.no_grad():
            trainer.camera_deltas.copy_(torch.from_numpy(case["deltas"]))
        trainer.iteration = case["iteration"]
        us, vs, u_strat, u_pdf = (torch.from_numpy(x) for x in case["draws"])
        loss, loss_dict, mse = trainer.step_grads(case["camera"], us, vs, u_strat, u_pdf)
        cam = trainer.camera_deltas.grad
        results.append({
            "loss": loss.item(), "mse": mse.item(),
            "loss_dict": {k: v.item() for k, v in loss_dict.items()},
            "grads": {n: p.grad.numpy().copy()
                      for n, p in trainer.neural_render.named_parameters()},
            "camera": None if cam is None else cam.numpy().copy(),
        })
    _save(out, results)


def render(inputs: dict, out: str) -> None:
    """``render_image`` of a seeded renderer through
    ``make_sharded_render`` and in this rank alone, for each case (chunk,
    ray cull); both from generators seeded alike."""
    _threads()
    renderer = NeRFRender(network_config=dict(inputs["network"]), sample_coarse=8,
                          sample_fine=16, use_coarse_network=False, sampling_type="point",
                          generator=torch.Generator().manual_seed(inputs["seed"]))
    calib, r, t = (torch.from_numpy(x) for x in inputs["camera"])
    grid = OccupancyGrid(torch.from_numpy(inputs["grid"]), 1.1, 0.5)
    shard = make_sharded_render()
    results = []
    for chunk, cull in inputs["cases"]:
        images = []
        for render_fn in (shard, None):
            images.append(renderer.render_image(
                PinholeCalib(calib), r, t, 300, 260, ["color", "depth", "transmittance"],
                inputs["downsampling"], chunk, generator=torch.Generator().manual_seed(3),
                ray_cull=grid if cull else None, render_fn=render_fn))
        results.append(images)
    _save(out, results)


def steps(inputs: dict, out: str) -> None:
    """``run_train_step`` over ``inputs["cameras"]`` by a trainer of
    ``mesh.data`` = world: its history and parameters."""
    _threads()
    trainer = _trainer(inputs["cfg"])
    for camera_id in inputs["cameras"]:
        trainer.run_train_step(camera_id)
    trainer.flush_logs()
    _save(out, {"history": trainer.history, "params": {
        n: p.detach().numpy().copy() for n, p in trainer.neural_render.named_parameters()}})


def fail(inputs: dict, out: str) -> None:
    """Rank 1 raises while rank 0 waits for it in an all-reduce."""
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.all_reduce(torch.zeros(1))


TASKS = {"grads": grads, "render": render, "steps": steps, "fail": fail}


def main(argv) -> None:
    task, inputs, out, world = argv
    launch(TASKS[task], (torch.load(inputs, weights_only=False), out), int(world), "cpu",
           Path(out).parent)


if __name__ == "__main__":
    main(sys.argv[1:])
