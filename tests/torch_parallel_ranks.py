"""Rank programs of the port's data- and tensor-parallel tests
(``test_torch_parallel.py``, ``test_torch_parallel_trainer.py``,
``test_torch_tp.py``, ``test_torch_tp_mesh4.py``,
``test_torch_tp_families_ranks.py``), run in a process of
their own:

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


def _tp_trainer(cfg: dict, state=None):
    """A trainer of ``cfg``'s mesh (tensor parallelism) with the full
    parameters ``state``, this rank keeping its shards."""
    trainer = tconfig.instantiate(cfg["trainer"], global_config=cfg)
    if state is not None:
        full = {k: torch.from_numpy(v) for k, v in state.items()}
        trainer.neural_render.load_state_dict(trainer.local_state(full), strict=True)
    return trainer


def _tp_walks(inputs: dict) -> list:
    """The per-layer walk over this rank's column shards of each case's
    weights (its model group: the default one), forward and backward:
    the gathered output, the input cotangents, the gathered dW and db."""
    from neddf_tpu_torch.kernels import dual_mlp as tdm
    from neddf_tpu_torch.parallel.tp import all_gather_last

    group = dist.group.WORLD
    n, r = dist.get_world_size(), dist.get_rank()
    # one thread, as the test's whole walk: a multi-threaded f32 product
    # may split its sums by shape, and these shards are half as wide
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    results = []
    for case in inputs["walks"]:
        vs, js, ws, bs, layout, act, has_j, n_tan, g = case
        cd = vs[0].dtype
        per = ws[0].shape[1] // n
        cols = slice(r * per, (r + 1) * per)
        k = tdm.DualProductsPlain(cd)
        full, ins, pres = tdm.dual_mlp_layers_walk(
            vs, js, [w[:, cols].contiguous() for w in ws], [b[cols] for b in bs], layout, act,
            has_j, n_tan, k, group, stash=True)
        # each rank's share of one cotangent (the gathers' backward sums them)
        dvs, djs, dws, dbs = tdm.dual_mlp_layers_bwd(
            ins, [w[:, cols].contiguous() for w in ws], layout, act, [v.shape[1] for v in vs],
            has_j, pres, g / n, k, group)
        results.append({"full": full, "dvs": dvs, "djs": djs,
                        "dws": [all_gather_last(d, group) for d in dws],
                        "dbs": [all_gather_last(d, group) for d in dbs]})
    torch.set_num_threads(threads)
    return results


def tp(inputs: dict, out: str) -> None:
    """Tensor parallelism over this world as one model group (data 1):
    ``tp_gather`` forward and backward, the padded gather against the
    gather; the per-layer walks; one step of a NeDDF trainer on the given
    draws (loss, loss dict, mse, gathered gradients, camera gradient);
    the TP eval render and the render of the gathered copy; two training
    steps, then a checkpoint (its path in the inputs)."""
    from neddf_tpu_torch.parallel.tp import gather_by_all_reduce, tp_gather

    _threads()
    group = dist.group.WORLD
    n, r = dist.get_world_size(), dist.get_rank()
    x = (torch.arange(2 * 3 * 5, dtype=torch.float32).view(2, 3, 5) * (r + 1) - 7.0)
    x[0, 0, 0] = -0.0
    x.requires_grad_(True)
    y = tp_gather(x, group)
    g = torch.arange(y.numel(), dtype=torch.float32).view_as(y) * (0.5 + r)
    y.backward(g)
    result = {"x": x.detach(), "y": y.detach(), "g": g, "dx": x.grad,
              "padded": gather_by_all_reduce(x.detach(), group)}
    result["walks"] = _tp_walks(inputs)

    case = inputs["step"]
    trainer = _tp_trainer(case["cfg"], case["state"])
    with torch.no_grad():
        trainer.camera_deltas.copy_(torch.from_numpy(case["deltas"]))
    trainer.iteration = case["iteration"]
    us, vs, u_strat, u_pdf = (torch.from_numpy(a) for a in case["draws"])
    loss, loss_dict, mse = trainer.step_grads(case["camera"], us, vs, u_strat, u_pdf)
    grads = trainer.full_state({n_: p.grad for n_, p in trainer.neural_render.named_parameters()})
    result["step"] = {
        "loss": loss.item(), "mse": mse.item(),
        "loss_dict": {k: v.item() for k, v in loss_dict.items()},
        "grads": {k: v.numpy().copy() for k, v in grads.items()},
        "camera": trainer.camera_deltas.grad.numpy().copy()}

    render = inputs["render"]
    calib, pose_r, pose_t = (torch.from_numpy(a) for a in render["camera"])
    images = []
    for renderer, render_fn in ((trainer.neural_render, trainer.render_fn),
                                (trainer.full_renderer(), None)):
        images.append(renderer.render_image(
            PinholeCalib(calib), pose_r, pose_t, 24, 20, ["color", "depth"], 1,
            trainer.chunk, generator=torch.Generator().manual_seed(3), render_fn=render_fn))
    result["render"] = images

    run = inputs["run"]
    trainer = _tp_trainer(run["cfg"])
    for camera_id in run["cameras"]:
        trainer.run_train_step(camera_id)
    trainer.flush_logs()
    trainer.save_checkpoint(run["path"])
    full = trainer.full_state(dict(trainer.neural_render.named_parameters()))
    result["run"] = {"history": trainer.history,
                     "params": {k: v.detach().numpy().copy() for k, v in full.items()}}
    _save(out, result)


def fail(inputs: dict, out: str) -> None:
    """Rank 1 raises while rank 0 waits for it in an all-reduce."""
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.all_reduce(torch.zeros(1))


def tp_camera(inputs: dict, out: str) -> None:
    """One step of a NeDDF trainer of ``mesh`` data x model over this
    world, with ``optimize_camera``, on the given draws: the camera-delta
    gradient, the loss and mse (every rank)."""
    _threads()
    case = inputs["step"]
    trainer = _tp_trainer(case["cfg"], case["state"])
    with torch.no_grad():
        trainer.camera_deltas.copy_(torch.from_numpy(case["deltas"]))
    trainer.iteration = case["iteration"]
    loss, _, mse = trainer.step_grads(case["camera"], *(torch.from_numpy(a)
                                                        for a in case["draws"]))
    _save(out, {"loss": loss.item(), "mse": mse.item(),
                "camera": trainer.camera_deltas.grad.numpy().copy()})


def _family_walks(inputs: dict) -> list:
    """NeRF's and NeuS's per-layer walks over this rank's column shards of
    each case's weights (the default group), forward and backward, each
    rank given 1/n of the cotangents (the collectives' adjoints sum them):
    the value-only walk (``hidden_first``; NeuS's colour trunk with its
    last layer whole), and the sdf trunk with its sweep through the
    route's plain launcher and through ``ops/sdf_grad.py``'s plain
    versions with the group. Returns the gathered outputs and shards."""
    from neddf_tpu_torch.kernels import dual_mlp as tdm
    from neddf_tpu_torch.kernels import mlp as tmlp
    from neddf_tpu_torch.kernels import sdf_mlp as tsdf
    from neddf_tpu_torch.ops import sdf_grad as tgrad
    from neddf_tpu_torch.parallel.tp import all_gather_last

    group = dist.group.WORLD
    n, r = dist.get_world_size(), dist.get_rank()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the test's whole walks

    def shard(ws, bs, whole_last=False):
        per = ws[0].shape[1] // n
        cols = slice(r * per, (r + 1) * per)
        keep = [whole_last and i == len(ws) - 1 for i in range(len(ws))]
        return ([w if k else w[:, cols].contiguous() for w, k in zip(ws, keep)],
                [b if k else b[cols].contiguous() for b, k in zip(bs, keep)], keep)

    def gather(ts, keep):
        return [t if k else all_gather_last(t, group) for t, k in zip(ts, keep)]

    results = []
    for case in inputs["family_walks"]:
        if case["kind"] == "mlp":
            vs, ws, bs, layout, narrow, g = (case[k] for k in
                                             ("vs", "ws", "bs", "layout", "narrow", "g"))
            wsh, bsh, keep = shard(ws, bs, narrow)
            k = tmlp.mlp_layer_launcher(vs[0].dtype, vs[0].device, True)
            no_j = (False,) * len(vs)
            full, ins, pres = tdm.dual_mlp_layers_walk(
                vs, [], wsh, bsh, layout, "ReLU", no_j, 0, k, group, stash=True,
                hidden_first=True, whole_last=narrow)
            dvs, _, dws, dbs = tdm.dual_mlp_layers_bwd(
                ins, wsh, layout, "ReLU", [v.shape[1] for v in vs], no_j, pres, (g / n)[None],
                k, group, hidden_first=True, whole_last=narrow)
            results.append({"full": full[0], "dvs": dvs, "dws": gather(dws, keep),
                            "dbs": gather(dbs, keep)})
            continue
        e, ws, bs, layout, act, ch, cg = (case[k] for k in
                                          ("e", "ws", "bs", "layout", "act", "ch", "cg"))
        wsh, bsh, keep = shard(ws, bs)
        out = {}
        k = tsdf.sdf_layer_launcher(e.device, True)
        h, g_e, ins, pres = tsdf.sdf_layers_walk(e, wsh, bsh, layout, act, k, group)
        de, dws, dbs = tsdf.sdf_layers_bwd(ins, wsh, layout, act, pres, ch / n, cg / n, k, group)
        out["route"] = {"h": h, "g_e": g_e, "de": de, "dws": gather(dws, keep),
                        "dbs": gather(dbs, keep)}
        h, g_e, zs = tgrad.sdf_trunk_with_grad(e, wsh, bsh, layout, act, stash=True,
                                               group=group)
        de, dws, dbs = tgrad.sdf_trunk_with_grad_vjp(e, wsh, layout, act, zs, ch / n, cg / n,
                                                     group)
        out["plain"] = {"h": h, "g_e": g_e, "de": de, "dws": gather(dws, keep),
                        "dbs": gather(dbs, keep)}
        results.append(out)
    torch.set_num_threads(threads)
    return results


def tp_families(inputs: dict, out: str) -> None:
    """NeRF and NeuS under tensor parallelism over this world as one model
    group (data 1): the per-layer walks; per family one step on the given
    draws (loss, loss dict, mse, gathered gradients, camera gradient), the
    TP eval render and the render of the gathered copy, and two training
    steps, then a checkpoint (its path in the inputs)."""
    _threads()
    result = {"walks": _family_walks(inputs)}
    for family, case in inputs["families"].items():
        step = case["step"]
        trainer = _tp_trainer(step["cfg"], step["state"])
        with torch.no_grad():
            trainer.camera_deltas.copy_(torch.from_numpy(step["deltas"]))
        trainer.iteration = step["iteration"]
        us, vs, u_strat, u_pdf = (torch.from_numpy(a) for a in step["draws"])
        loss, loss_dict, mse = trainer.step_grads(step["camera"], us, vs, u_strat, u_pdf)
        grads = trainer.full_state({n: p.grad
                                    for n, p in trainer.neural_render.named_parameters()})
        res = {"step": {
            "loss": loss.item(), "mse": mse.item(),
            "loss_dict": {k: v.item() for k, v in loss_dict.items()},
            "grads": {k: v.numpy().copy() for k, v in grads.items()},
            "camera": trainer.camera_deltas.grad.numpy().copy()}}
        calib, pose_r, pose_t = (torch.from_numpy(a) for a in inputs["render_camera"])
        res["render"] = [renderer.render_image(
            PinholeCalib(calib), pose_r, pose_t, 24, 20, ["color", "depth"], 1, trainer.chunk,
            generator=torch.Generator().manual_seed(3), render_fn=render_fn)
            for renderer, render_fn in ((trainer.neural_render, trainer.render_fn),
                                        (trainer.full_renderer(), None))]
        run = case["run"]
        trainer = _tp_trainer(run["cfg"])
        for camera_id in run["cameras"]:
            trainer.run_train_step(camera_id)
        trainer.flush_logs()
        trainer.save_checkpoint(run["path"])
        full = trainer.full_state(dict(trainer.neural_render.named_parameters()))
        res["run"] = {"history": trainer.history,
                      "params": {k: v.detach().numpy().copy() for k, v in full.items()}}
        result[family] = res
    _save(out, result)


TASKS = {"grads": grads, "render": render, "steps": steps, "fail": fail, "tp": tp,
         "tp_camera": tp_camera, "tp_families": tp_families}


def main(argv) -> None:
    task, inputs, out, world = argv
    launch(TASKS[task], (torch.load(inputs, weights_only=False), out), int(world), "cpu",
           Path(out).parent)


if __name__ == "__main__":
    main(sys.argv[1:])
