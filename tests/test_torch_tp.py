"""The port's tensor parallelism (``trainer.mesh.model=2``) on the CPU, over
2 gloo ranks (data 1 x model 2), against the JAX package's ``(data,
model)`` mesh and the port's one process.

* ``parallel/tp.py::tp_gather``: its forward is the concat of the ranks'
  slices in rank order, its backward the sum over the ranks of each
  rank's cotangent slice, and the zero-padded ``all_reduce`` form (gloo's
  gather for CUDA tensors) is bitwise the ``all_gather`` form.
* The per-layer walk at width 640 over two column shards, with its
  collectives, against the whole walk in one process (the K=3 trunk in
  f32, the K=1 colour trunk in bf16), and at width 4096 (shards of 2048,
  the K=3 trunk's layer 0 and a post-skip layer, f32).
* One TP step of ``NeRFTrainer`` (NeDDF, f32, ``optimize_camera``, the
  JAX package's draws and weights) against the JAX package's
  ``make_sharded_grads`` on a 1 x 2 mesh (its ``tp_renderer`` route)
  and against the port's single-process step.
* The TP eval render against the render of the gathered copy in one
  rank.
* Two training steps at ``model = 2``: their parameters against two
  single-process steps; the checkpoint loads in the JAX package's trainer
  and resumes at ``model = 1`` (``load_checkpoint`` in one process).
* NeRF and NeuS at ``model = 2`` refuse only what every family does (a
  trainer outside a process group of the mesh's size); the route takes
  any width (4096 here), and refuses an unknown activation, named.

One launch of the ranks (``tests/torch_parallel_ranks.py`` task ``tp``),
started in the background while the JAX references compute. Tolerances:
the step within the JAX package's own TP bar (rtol 2e-4, atol 2e-6,
``tests/parallel/test_mesh.py:176``) against both; the walk against the
whole walk f32 1e-6, bf16 2^-8 of the largest magnitude (sums in another
order; dW and db alike; the input cotangents, each rank's part rounded
to bf16 before their sum, 2^-7); the render within 1e-5 (``test_mesh.py:198``); the two steps'
parameters within the DP trainer test's Adam bounds (rtol 2e-3, atol
4e-3, ``test_torch_parallel_trainer.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neddf_tpu import config as jconfig
from neddf_tpu.parallel.mesh import make_mesh
from neddf_tpu.parallel.mesh import make_sharded_grads as jmake_sharded_grads
from neddf_tpu.parallel.mesh import tp_renderer as jtp_renderer
from neddf_tpu.training.step import make_local_grads
from neddf_tpu_torch import config as tconfig
from neddf_tpu_torch.kernels import dual_mlp as tdm
from neddf_tpu_torch.training.checkpoint import load_msgpack_params, params_from_jax
from tests.test_torch_parallel import (  # noqa: F401  (scene is a fixture)
    CAMERA,
    DELTA,
    ITERATION,
    family_config,
    scene,
    start_ranks,
)
from tests.test_torch_train_field import _flat_grads
from tests.test_torch_train_step import _jax_draws
from tests.test_torch_widths_acts import _dual_cfg, _dual_inputs, _rel

MESH_TP = {"data": 1, "model": 2}
WALK_TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0**-8}


def _walk_cases():
    cases = []
    for name, dtype in (("trunk", torch.float32), ("color", torch.bfloat16)):
        cfg = _dual_cfg(640)[name]
        args, bs = _dual_inputs(cfg, 640, dtype, "tanhExp", seed=len(name))
        vs, js, ws, layout, act, has_j, _, gv, gj = args
        g = torch.cat([gv[None], gj], dim=0)
        cases.append((vs, js, ws, bs, layout, act, has_j, cfg["n_tan"], g))
    # a full width of 4096 in shards of 2048 (past the epilogue's staged
    # classes): the K=3 trunk's layer 0 and a post-skip layer, f32, 16 rows
    rng = np.random.default_rng(4096)
    width, m = 4096, 16
    vs = [torch.tensor(rng.normal(size=(m, 24)), dtype=torch.float32)]
    js = [torch.tensor(rng.normal(size=(3, m, 24)), dtype=torch.float32)]
    ws = [torch.tensor(rng.normal(scale=fan ** -0.5, size=(fan, width)), dtype=torch.float32)
          for fan in (24, width + 24)]
    bs = [torch.tensor(rng.normal(scale=0.1, size=width), dtype=torch.float32)] * 2
    g = torch.tensor(rng.normal(size=(4, m, width)), dtype=torch.float32)
    cases.append((vs, js, ws, bs, (False, True), "tanhExp", (True,), 3, g))
    return cases


@pytest.fixture(scope="module")
def tp_case(scene, tmp_path_factory):
    """The JAX trainer, its key, and the rank task's inputs; the ranks
    start here, in the background."""
    key = jax.random.PRNGKey(11)
    cfg = family_config(scene, "neddf", optimize_camera=True)
    cfg["network"]["fused"] = "auto"  # the port's own route (plain launchers on the CPU)
    jtr = jconfig.instantiate(cfg["trainer"], global_config=cfg)
    deltas = np.zeros(np.shape(jtr.camera_deltas), np.float32)
    deltas[CAMERA] = DELTA
    state = {k: v.numpy() for k, v in params_from_jax(jtr.params).items()}
    draws = [x.numpy() for x in _jax_draws(jtr, key)]
    draws[:2] = [x.astype(np.int64) for x in draws[:2]]
    tp_cfg = {**cfg, "trainer": {**cfg["trainer"], "mesh": MESH_TP}}
    root = tmp_path_factory.mktemp("tp")
    run_cfg = family_config(scene, "neddf")
    run_cfg["network"]["fused"] = "auto"
    inputs = {
        "walks": _walk_cases(),
        "step": {"cfg": tp_cfg, "state": state, "deltas": deltas, "iteration": ITERATION,
                 "camera": CAMERA, "draws": draws},
        "render": {"camera": (np.array([30.0, 30.0, 12.0, 10.0], np.float32),
                              np.eye(3, dtype=np.float32),
                              np.array([0.0, 0.0, 4.0], np.float32))},
        "run": {"cfg": {**run_cfg, "trainer": {**run_cfg["trainer"], "mesh": MESH_TP}},
                "cameras": [0, 1], "path": str(root / "model_tp.ckpt")},
    }
    ranks, outputs = start_ranks("tp", inputs, root)
    yield {"jtr": jtr, "key": key, "cfg": cfg, "run_cfg": run_cfg, "inputs": inputs,
           "outputs": outputs}
    ranks.stop()


def test_tp_gather_is_the_concat_and_its_backward_the_sum(tp_case):
    ranks = tp_case["outputs"]()
    want = torch.cat([r["x"] for r in ranks], dim=-1)
    for r, got in enumerate(ranks):
        assert torch.equal(got["y"], want)
        total = sum(o["g"] for o in ranks)
        assert torch.equal(got["dx"], total[..., r * 5 : (r + 1) * 5])
        # bitwise, the sign of the zero too
        assert torch.equal(got["padded"].view(torch.int32), got["y"].view(torch.int32))


@pytest.mark.parametrize("case", [0, 1, 2], ids=["trunk_f32", "color_bf16", "trunk_4096_f32"])
def test_two_shard_walk_matches_the_whole_walk(tp_case, case):
    vs, js, ws, bs, layout, act, has_j, n_tan, g = tp_case["inputs"]["walks"][case]
    dtype = vs[0].dtype
    k = tdm.DualProductsPlain(dtype)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks' walks (tests/torch_parallel_ranks.py)
    try:
        full, ins, pres = tdm.dual_mlp_layers_walk(vs, js, ws, bs, layout, act, has_j, n_tan,
                                                   k, stash=True)
        dvs, djs, dws, dbs = tdm.dual_mlp_layers_bwd(ins, ws, layout, act,
                                                     [v.shape[1] for v in vs], has_j, pres, g, k)
    finally:
        torch.set_num_threads(threads)
    ranks = [r["walks"][case] for r in tp_case["outputs"]()]
    tol = WALK_TOL[dtype]
    for got in ranks:
        assert _rel(got["full"], full) <= tol, _rel(got["full"], full)
        for i, (a, b) in enumerate(zip(got["dws"], dws)):
            assert _rel(a, b) <= tol, ("dW", i, _rel(a, b))
        # db sums a layer's f32 cotangent, which in bf16 inherits the upper
        # layers' roundings: the shards' sums in another order take the
        # other bf16 neighbour in some elements (98 of 597,760 of the
        # colour trunk's layer-1 cotangent), so db has dW's bar
        for i, (a, b) in enumerate(zip(got["dbs"], dbs)):
            assert _rel(a, b) <= tol, ("db", i, _rel(a, b))
    # each rank's input cotangents are its columns' part, rounded to the
    # compute dtype; their sum the whole (two roundings in bf16)
    sum_tol = tol if dtype == torch.float32 else 2 * tol
    for i, want in enumerate(dvs):
        assert _rel(sum(r["dvs"][i].float() for r in ranks), want) <= sum_tol
    for i, want in enumerate(djs):
        assert _rel(sum(r["djs"][i].float() for r in ranks), want) <= sum_tol


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-6, err_msg=what)


def test_tp_step_matches_the_jax_tp_mesh_and_the_single_step(tp_case):
    jtr, key, case = tp_case["jtr"], tp_case["key"], tp_case["inputs"]["step"]
    refs = {}
    for name, mesh, renderer in (("tp", make_mesh(2, model=2), jtp_renderer(jtr.neural_render)),
                                 ("one", make_mesh(1), jtr.neural_render)):
        local = make_local_grads(renderer, jtr.loss_functions, jtr.calib,
                                 jtr.dataset.image_width, jtr.dataset.image_height,
                                 jtr.batch_size, optimize_camera=True)
        grads_fn = jax.jit(jmake_sharded_grads(mesh, local, jtr.batch_size))
        loss, loss_dict, mse, grads, grads_cam = grads_fn(*jax.device_get((
            jtr.params, case["deltas"], jtr.rgb_images, jtr.mask_images, jtr.camera_initials,
            key, jnp.int32(CAMERA), jnp.int32(ITERATION))))
        refs[name] = {"loss": float(loss), "mse": float(mse),
                      "loss_dict": {k: float(v) for k, v in loss_dict.items()},
                      "grads": _flat_grads(grads), "camera": np.asarray(grads_cam)}
    ttr = tconfig.instantiate(tp_case["cfg"]["trainer"], global_config=tp_case["cfg"])
    ttr.neural_render.load_state_dict({k: torch.from_numpy(v) for k, v in case["state"].items()})
    with torch.no_grad():
        ttr.camera_deltas.copy_(torch.from_numpy(case["deltas"]))
    ttr.iteration = ITERATION
    loss, loss_dict, mse = ttr.step_grads(CAMERA, *(torch.from_numpy(x) for x in case["draws"]))
    refs["port"] = {"loss": loss.item(), "mse": mse.item(),
                    "loss_dict": {k: v.item() for k, v in loss_dict.items()},
                    "grads": {n: p.grad.numpy() for n, p in ttr.neural_render.named_parameters()},
                    "camera": ttr.camera_deltas.grad.numpy()}
    ranks = [r["step"] for r in tp_case["outputs"]()]
    for which, want in refs.items():
        for rank, got in enumerate(ranks):
            what = f"rank {rank} vs {which}"
            _close(got["loss"], want["loss"], what)
            _close(got["mse"], want["mse"], what)
            for k, v in want["loss_dict"].items():
                _close(got["loss_dict"][k], v, f"{what} {k}")
            assert set(got["grads"]) == set(want["grads"])
            for name, g in want["grads"].items():
                _close(got["grads"][name], g, f"{what} {name}")
            _close(got["camera"], want["camera"], f"{what} camera")
    assert np.abs(refs["tp"]["camera"][CAMERA]).max() > 0


def test_tp_render_matches_the_gathered_render(tp_case):
    for rank, (tp, one) in enumerate(r["render"] for r in tp_case["outputs"]()):
        for k in ("color", "depth"):
            assert tp[k].shape == one[k].shape
            np.testing.assert_allclose(tp[k], one[k], rtol=0, atol=1e-5, err_msg=f"{rank} {k}")


def test_tp_checkpoint_equals_one_process_loads_in_jax_and_resumes_at_model_1(tp_case):
    cfg = tp_case["run_cfg"]
    inputs = tp_case["inputs"]["run"]
    single = tconfig.instantiate(cfg["trainer"], global_config=cfg)
    for camera_id in inputs["cameras"]:
        single.run_train_step(camera_id)
    single.flush_logs()
    ranks = [r["run"] for r in tp_case["outputs"]()]
    for rank, got in enumerate(ranks):
        for mine, want in zip(got["history"], single.history):
            np.testing.assert_allclose(mine["loss"], want["loss"], rtol=1e-5, err_msg=rank)
        for name, p in single.neural_render.named_parameters():
            np.testing.assert_allclose(got["params"][name], p.detach().numpy(), rtol=2e-3,
                                       atol=4e-3, err_msg=name)
            np.testing.assert_array_equal(got["params"][name], ranks[0]["params"][name])
    path = inputs["path"]
    saved = {k: v.numpy() for k, v in params_from_jax(load_msgpack_params(path)).items()}
    for name, value in ranks[0]["params"].items():
        np.testing.assert_array_equal(saved[name], value, err_msg=name)
    jtr = jconfig.instantiate(cfg["trainer"], global_config=cfg)
    jtr.load_checkpoint(path)
    assert int(jtr.iteration) == 2
    for name, value in params_from_jax(jax.device_get(jtr.params)).items():
        np.testing.assert_array_equal(value.numpy(), saved[name], err_msg=name)
    resumed = tconfig.instantiate(cfg["trainer"], global_config=cfg)
    resumed.load_checkpoint(path)
    assert resumed.iteration == 2
    resumed.run_train_step(0)
    resumed.flush_logs()
    assert np.isfinite(resumed.history[-1]["loss"])


@pytest.mark.parametrize("family", ["nerf", "neus"])
def test_nerf_and_neus_refuse_width_sharding(scene, family):
    """NeRF and NeuS take tensor parallelism since their slice
    (``tests/test_torch_tp_families_ranks.py`` runs their steps): at
    ``model = 2`` a trainer refuses only what it refuses for any family, a
    process outside a group of 2 ranks; the per-layer route takes any full
    width (4096: shards of 2048) and names what it refuses."""
    cfg = family_config(scene, family, mesh=MESH_TP)
    with pytest.raises(RuntimeError, match="process group of 2"):
        tconfig.instantiate(cfg["trainer"], global_config=cfg)
    assert tdm.route_refusal("ReLU", 4096, 0) is None
    assert tdm.route_refusal("GELU", 4096, 0) == "activation 'GELU'"
