"""NeRF's and NeuS's tensor parallelism (``trainer.mesh.model=2``) on the
CPU, over 2 gloo ranks (data 1 x model 2), against the JAX package's
``(data, model)`` mesh, the port's one process and the whole layers.

* The per-layer walks as two column shards against the whole walk in one
  process: the value-only walk with NeRF's hidden-first post-skip layer
  (f32 and bf16) and NeuS's colour trunk (its 3-wide last layer whole on
  both ranks), and the sdf trunk with its sweep and second-order
  backward (ReLU and tanhExp), through the route's plain launcher and
  through ``ops/sdf_grad.py``'s plain versions with the model group.
* One TP step per family (``optimize_camera`` on, ``tests/parallel/
  test_mesh.py``'s SMALL_NERF / SMALL_NEUS sizes, f32, the JAX package's
  draws and weights) against the JAX package's ``make_sharded_grads`` on
  a 1 x 2 mesh (its ``tp_renderer`` route) and against the port's
  single-process step: loss, loss dict, mse, every gathered gradient, the
  camera gradient.
* The TP eval render against the render of the gathered copy in one rank.
* Two training steps at ``model = 2`` per family: their parameters
  against two single-process steps; the checkpoint loads in the JAX
  package's trainer and resumes at ``model = 1``.

One launch of the ranks (``tests/torch_parallel_ranks.py`` task
``tp_families``), started in the background while the JAX references
compute. Tolerances: the step within the JAX package's own TP bar (rtol
2e-4, atol 2e-6, ``tests/parallel/test_mesh.py:176``) against both; the
walks against the whole walks f32 1e-6 and bf16 2^-8 of the largest
magnitude (sums in another order), the input cotangents, each rank's part
rounded before their sum, twice that; the render within 1e-5; the two
steps' parameters within the DP trainer test's Adam bounds (rtol 2e-3,
atol 4e-3).
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
from neddf_tpu_torch.kernels import mlp as tmlp
from neddf_tpu_torch.kernels import sdf_mlp as tsdf
from neddf_tpu_torch.training.checkpoint import load_msgpack_params, params_from_jax
from tests.test_torch_parallel import (  # noqa: F401  (scene is a fixture)
    CAMERA,
    DELTA,
    ITERATION,
    family_config,
    scene,
    start_ranks,
)
from tests.test_torch_tp_families import SMALL
from tests.test_torch_train_field import _flat_grads
from tests.test_torch_train_step import _jax_draws
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

MESH_TP = {"data": 1, "model": 2}
FAMILIES = ("nerf", "neus")
WIDE, ROWS = 640, 256
WALK_TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0**-8}


def _rel(got, ref):
    got, ref = np.asarray(got.float(), np.float32), np.asarray(ref.float(), np.float32)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)


def _walk_cases():
    """The value-only walks (NeRF's trunk f32 and bf16, NeuS's colour trunk)
    and the sdf walks (ReLU, tanhExp) at width 640."""
    rng = np.random.default_rng(21)

    def t(a, dtype=torch.float32):
        return torch.tensor(a, dtype=torch.float32).to(dtype)

    cases = []
    for widths, layout, narrow, dtype in (
            ((24,), (False, False, True, False), False, torch.float32),
            ((24,), (False, False, True, False), False, torch.bfloat16),
            ((3, 12, 3, WIDE), (False, False, False), True, torch.float32)):
        vs = [t(rng.normal(size=(ROWS, w)), dtype) for w in widths]
        ws, bs = [], []
        for li, split in enumerate(layout):
            fan = sum(widths) if li == 0 else WIDE + widths[0] * split
            out = 3 if narrow and li == len(layout) - 1 else WIDE
            ws.append(t(rng.normal(scale=1.5 * fan ** -0.5, size=(fan, out)), dtype))
            bs.append(t(rng.normal(scale=0.1, size=out)))
        cases.append({"kind": "mlp", "vs": vs, "ws": ws, "bs": bs, "layout": layout,
                      "narrow": narrow, "g": t(rng.normal(size=(ROWS, ws[-1].shape[1])))})
    layout, e_dim = (False, False, True, False), 36
    for act in ("ReLU", "tanhExp"):
        ws = [t(rng.normal(scale=1.5 * fan ** -0.5, size=(fan, WIDE)))
              for fan in [e_dim] + [WIDE + e_dim * s for s in layout[1:]]]
        cases.append({"kind": "sdf", "e": t(rng.normal(size=(ROWS, e_dim))), "ws": ws,
                      "bs": [t(rng.normal(scale=0.1, size=WIDE)) for _ in ws],
                      "layout": layout, "act": act, "ch": t(rng.normal(size=(ROWS, WIDE))),
                      "cg": t(rng.normal(size=(ROWS, e_dim)))})
    return cases


def _config(scene, family, **trainer):
    cfg = family_config(scene, family, **trainer)
    cfg["network"].update(SMALL[family])
    cfg["network"]["fused"] = "auto"  # the port's own route (plain launchers on the CPU)
    return cfg


@pytest.fixture(scope="module")
def tp_case(scene, tmp_path_factory):
    """Per family the JAX trainer, its config and the rank task's inputs;
    the ranks start here, in the background."""
    key = jax.random.PRNGKey(13)
    root = tmp_path_factory.mktemp("tp_families")
    jtrs, families = {}, {}
    for family in FAMILIES:
        cfg = _config(scene, family, optimize_camera=True)
        jtr = jconfig.instantiate(cfg["trainer"], global_config=cfg)
        deltas = np.zeros(np.shape(jtr.camera_deltas), np.float32)
        deltas[CAMERA] = DELTA
        state = {k: v.numpy() for k, v in params_from_jax(jtr.params).items()}
        draws = [x.numpy() for x in _jax_draws(jtr, key)]
        draws[:2] = [x.astype(np.int64) for x in draws[:2]]
        run_cfg = _config(scene, family)
        jtrs[family] = (jtr, cfg, run_cfg)
        families[family] = {
            "step": {"cfg": {**cfg, "trainer": {**cfg["trainer"], "mesh": MESH_TP}},
                     "state": state, "deltas": deltas, "iteration": ITERATION,
                     "camera": CAMERA, "draws": draws},
            "run": {"cfg": {**run_cfg, "trainer": {**run_cfg["trainer"], "mesh": MESH_TP}},
                    "cameras": [0, 1], "path": str(root / f"{family}_tp.ckpt")}}
    inputs = {"family_walks": _walk_cases(), "families": families,
              "render_camera": (np.array([30.0, 30.0, 12.0, 10.0], np.float32),
                                np.eye(3, dtype=np.float32),
                                np.array([0.0, 0.0, 4.0], np.float32))}
    ranks, outputs = start_ranks("tp_families", inputs, root)
    yield {"key": key, "jtrs": jtrs, "inputs": inputs, "outputs": outputs}
    ranks.stop()


def _whole_walk(case):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks' walks
    try:
        if case["kind"] == "mlp":
            vs, ws, layout, narrow = case["vs"], case["ws"], case["layout"], case["narrow"]
            k = tmlp.mlp_layer_launcher(vs[0].dtype, vs[0].device, True)
            no_j = (False,) * len(vs)
            full, ins, pres = tdm.dual_mlp_layers_walk(
                vs, [], ws, case["bs"], layout, "ReLU", no_j, 0, k, stash=True,
                hidden_first=True, whole_last=narrow)
            dvs, _, dws, dbs = tdm.dual_mlp_layers_bwd(
                ins, ws, layout, "ReLU", [v.shape[1] for v in vs], no_j, pres, case["g"][None],
                k, hidden_first=True, whole_last=narrow)
            return {"full": full[0], "dvs": dvs, "dws": dws, "dbs": dbs}
        k = tsdf.sdf_layer_launcher(case["e"].device, True)
        h, g_e, ins, pres = tsdf.sdf_layers_walk(case["e"], case["ws"], case["bs"],
                                                 case["layout"], case["act"], k)
        de, dws, dbs = tsdf.sdf_layers_bwd(ins, case["ws"], case["layout"], case["act"], pres,
                                           case["ch"], case["cg"], k)
        return {"h": h, "g_e": g_e, "de": de, "dws": dws, "dbs": dbs}
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("case", range(5), ids=["nerf_trunk_f32", "nerf_trunk_bf16",
                                                "neus_color_f32", "sdf_relu", "sdf_tanhexp"])
def test_two_shard_walk_matches_the_whole_walk(tp_case, case):
    spec = tp_case["inputs"]["family_walks"][case]
    want = _whole_walk(spec)
    ranks = [r["walks"][case] for r in tp_case["outputs"]()]
    if spec["kind"] == "mlp":
        dtype = spec["vs"][0].dtype
        tol = WALK_TOL[dtype]
        for got in ranks:
            assert _rel(got["full"], want["full"]) <= tol
            for i, (a, b) in enumerate(zip(got["dws"], want["dws"])):
                # the whole last layer: each rank's dW from its 1/n of g
                a = a * 2 if spec["narrow"] and i == len(want["dws"]) - 1 else a
                assert _rel(a, b) <= tol, ("dW", i, _rel(a, b))
            for i, (a, b) in enumerate(zip(got["dbs"], want["dbs"])):
                a = a * 2 if spec["narrow"] and i == len(want["dbs"]) - 1 else a
                assert _rel(a, b) <= tol, ("db", i, _rel(a, b))
        for i, b in enumerate(want["dvs"]):
            assert _rel(sum(r["dvs"][i].float() for r in ranks), b) <= 2 * tol, ("dv", i)
        return
    for got in ranks:
        for route in ("route", "plain"):
            g = got[route]
            for k in ("h", "g_e"):
                assert _rel(g[k], want[k]) <= WALK_TOL[torch.float32], (route, k)
            for i, (a, b) in enumerate(zip(g["dws"], want["dws"])):
                assert _rel(a, b) <= WALK_TOL[torch.float32], (route, "dW", i, _rel(a, b))
            for i, (a, b) in enumerate(zip(g["dbs"], want["dbs"])):
                assert _rel(a, b) <= WALK_TOL[torch.float32], (route, "db", i, _rel(a, b))
    for route in ("route", "plain"):
        de = sum(r["walks"][case][route]["de"] for r in tp_case["outputs"]())
        assert _rel(de, want["de"]) <= 2 * WALK_TOL[torch.float32], route


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-6, err_msg=what)


@pytest.mark.parametrize("family", FAMILIES)
def test_tp_step_matches_the_jax_tp_mesh_and_the_single_step(tp_case, family):
    jtr, cfg, _ = tp_case["jtrs"][family]
    key, case = tp_case["key"], tp_case["inputs"]["families"][family]["step"]
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
    ttr = tconfig.instantiate(cfg["trainer"], global_config=cfg)
    ttr.neural_render.load_state_dict({k: torch.from_numpy(v) for k, v in case["state"].items()})
    with torch.no_grad():
        ttr.camera_deltas.copy_(torch.from_numpy(case["deltas"]))
    ttr.iteration = ITERATION
    loss, loss_dict, mse = ttr.step_grads(CAMERA, *(torch.from_numpy(x) for x in case["draws"]))
    refs["port"] = {"loss": loss.item(), "mse": mse.item(),
                    "loss_dict": {k: v.item() for k, v in loss_dict.items()},
                    "grads": {n: p.grad.numpy() for n, p in ttr.neural_render.named_parameters()},
                    "camera": ttr.camera_deltas.grad.numpy()}
    ranks = [r[family]["step"] for r in tp_case["outputs"]()]
    for which, want in refs.items():
        for rank, got in enumerate(ranks):
            what = f"{family} rank {rank} vs {which}"
            _close(got["loss"], want["loss"], what)
            _close(got["mse"], want["mse"], what)
            for k, v in want["loss_dict"].items():
                _close(got["loss_dict"][k], v, f"{what} {k}")
            assert set(got["grads"]) == set(want["grads"])
            for name, g in want["grads"].items():
                _close(got["grads"][name], g, f"{what} {name}")
            _close(got["camera"], want["camera"], f"{what} camera")
    assert np.abs(refs["tp"]["camera"][CAMERA]).max() > 0


@pytest.mark.parametrize("family", FAMILIES)
def test_tp_render_matches_the_gathered_render(tp_case, family):
    for rank, r in enumerate(tp_case["outputs"]()):
        tp, one = r[family]["render"]
        for k in ("color", "depth"):
            assert tp[k].shape == one[k].shape
            np.testing.assert_allclose(tp[k], one[k], rtol=0, atol=1e-5,
                                       err_msg=f"{family} {rank} {k}")


@pytest.mark.parametrize("family", FAMILIES)
def test_tp_checkpoint_equals_one_process_loads_in_jax_and_resumes_at_model_1(tp_case, family):
    _, _, cfg = tp_case["jtrs"][family]
    inputs = tp_case["inputs"]["families"][family]["run"]
    single = tconfig.instantiate(cfg["trainer"], global_config=cfg)
    for camera_id in inputs["cameras"]:
        single.run_train_step(camera_id)
    single.flush_logs()
    ranks = [r[family]["run"] for r in tp_case["outputs"]()]
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
        np.testing.assert_array_equal(saved[name].reshape(value.shape), value, err_msg=name)
    jtr = jconfig.instantiate(cfg["trainer"], global_config=cfg)
    jtr.load_checkpoint(path)
    assert int(jtr.iteration) == 2
    for name, value in params_from_jax(jax.device_get(jtr.params)).items():
        np.testing.assert_array_equal(value.numpy().reshape(-1), saved[name].reshape(-1),
                                      err_msg=name)
    resumed = tconfig.instantiate(cfg["trainer"], global_config=cfg)
    resumed.load_checkpoint(path)
    assert resumed.iteration == 2
    resumed.run_train_step(0)
    resumed.flush_logs()
    assert np.isfinite(resumed.history[-1]["loss"])
