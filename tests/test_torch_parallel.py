"""The port's data parallelism (``neddf_tpu_torch/parallel/mesh.py``) on the
CPU, over gloo ranks, against the JAX package's mesh.

* Each rank's rows of the draws (the whole batch drawn from one
  generator state, ``step.py::rank_rows``) are the rows of the single
  process's draws, at 1, 2 and 4 ranks: the port's form of
  ``tests/parallel/test_mesh_trainer.py::test_pixel_draws_mesh_invariant``.
* One data-parallel step at 2 ranks (``NeRFTrainer.step_grads`` through
  ``make_sharded_grads``) on the JAX package's draws, with its weights
  (``params_from_jax``), against the JAX package's ``make_sharded_grads``
  on a 2-device virtual CPU mesh, for NeDDF, NeRF and NeuS in f32 at
  ``fused="off"`` with ``optimize_camera`` and ``grad_accum=2``; and
  against the port's single-process step.
* The validation errors and their texts are the JAX package's.
* ``make_sharded_render`` at 2 ranks against ``render_image`` in one
  process: a chunk that splits evenly, one that needs padding, and the
  ``ray_cull`` route; every rank holds the whole image.
* A launch on a device that is not the current one raises.

The ranks run in a process of their own (``tests/torch_parallel_ranks.py``,
started with a timeout). Tolerances, f32: the loss dict and every
gradient within 1e-5 of its norm, against the single-process step (sums
in another order: two half-batch means averaged; measured <= 4e-7) and
against the JAX mesh (measured <= 8.7e-6), except the camera-delta
gradient against the JAX mesh: 1e-4 of its norm, the bar
``test_torch_camera_accum.py`` holds the single-process port to against
JAX (the pose enters every ray and its terms cancel; NeuS's sits 1.4e-5
from JAX's in one process already, and the sharded step moves it by
3e-7). The renders within atol 1e-5 (the JAX mesh test's bound,
``test_mesh_trainer.py:191``).
"""
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neddf_tpu import config as jconfig
from neddf_tpu.parallel.mesh import make_mesh
from neddf_tpu.parallel.mesh import make_sharded_grads as jmake_sharded_grads
from neddf_tpu.training.step import make_local_grads
from neddf_tpu_torch import config as tconfig
from neddf_tpu_torch.data.synthetic import generate_sphere_dataset
from neddf_tpu_torch.kernels import _build
from neddf_tpu_torch.parallel.mesh import check_world_batch
from neddf_tpu_torch.training.checkpoint import params_from_jax
from neddf_tpu_torch.training.step import check_local_grad_accum, draw_pixel_batch, rank_rows
from tests.test_torch_train_field import _flat_grads
from tests.test_torch_train_step import _jax_draws
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

REPO = Path(__file__).resolve().parents[1]
RANKS_TIMEOUT = 300  # seconds; a hung rank fails the test instead of the run
TOL = 1e-5
CAMERA_JAX_TOL = 1e-4  # the port's camera gradient against JAX's (see the docstring)
FAMILIES = {
    "neddf": ([], dict(embed_pos_rank=4, embed_dir_rank=2, ddf_layer_count=4,
                       ddf_layer_width=16, col_layer_count=3, col_layer_width=16, skips=[1],
                       compute_dtype="float32")),
    "nerf": (["network=nerf", "render=nerf_render", "loss=nerf_loss"],
             dict(embed_pos_rank=4, embed_dir_rank=2, layer_count=4, layer_width=16,
                  skips=[1], compute_dtype="float32")),
    "neus": (["network=neus", "loss=nerf_loss"],
             dict(embed_pos_rank=4, embed_dir_rank=2, sdf_layer_count=4, sdf_layer_width=16,
                  col_layer_count=3, col_layer_width=16, skips=[1])),
}
# a pose delta of 0.29 rad (tests/test_torch_camera_accum.py::DELTA)
DELTA = np.array([0.2, -0.1, 0.18, 0.01, 0.02, -0.02], np.float32)
CAMERA, ITERATION = 1, 3
MESH2 = {"data": 2, "model": 1}


class Ranks:
    """A command (and the ranks it starts) in a session of its own, run in
    the background while the test computes its references."""

    def __init__(self, cmd, cwd=REPO) -> None:
        self.proc = subprocess.Popen(cmd, cwd=cwd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True, start_new_session=True)
        self.done = None

    def wait(self) -> subprocess.CompletedProcess:
        """Its exit code and output; at the time limit the session is killed."""
        if self.done is None:
            try:
                out, err = self.proc.communicate(timeout=RANKS_TIMEOUT)
            except subprocess.TimeoutExpired:
                self.stop()
                raise
            self.done = subprocess.CompletedProcess(self.proc.args, self.proc.returncode, out,
                                                    err)
        return self.done

    def stop(self) -> None:
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.communicate()


def start_ranks(task: str, inputs, tmp_path: Path, world: int = 2):
    """Start a task of ``tests/torch_parallel_ranks.py`` over ``world`` gloo
    ranks; returns (its ``Ranks``, a function that waits and returns each
    rank's outputs)."""
    torch.save(inputs, tmp_path / f"{task}.in")
    out = tmp_path / f"{task}.out"
    ranks = Ranks([sys.executable, "-m", "tests.torch_parallel_ranks", task,
                   str(tmp_path / f"{task}.in"), str(out), str(world)])

    def outputs() -> list:
        proc = ranks.wait()
        assert proc.returncode == 0, proc.stderr[-4000:]
        return [torch.load(f"{out}.rank{r}", weights_only=False) for r in range(world)]

    return ranks, outputs


def run_ranks(task: str, inputs, tmp_path: Path, world: int = 2) -> list:
    """Run a task of ``tests/torch_parallel_ranks.py`` over ``world`` gloo
    ranks; each rank's outputs."""
    return start_ranks(task, inputs, tmp_path, world)[1]()


def rel_to_norm(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return generate_sphere_dataset(tmp_path_factory.mktemp("scene"), n_train=2, n_test=1,
                                   image_size=16)


def family_config(scene, family, **trainer):
    overrides, network = FAMILIES[family]
    cfg = tconfig.compose(REPO / "config", overrides=["dataset=test", "trainer=test", *overrides])
    cfg["dataset"]["dataset_dir"] = str(scene)
    cfg["network"].update(network)
    cfg["network"]["fused"] = "off"
    cfg["render"].update({"sample_coarse": 4, "sample_fine": 4})
    cfg["trainer"].update({"batch_size": 16, "chunk": 64, **trainer})
    return cfg


# ------------------------------------------------------------------ the draws
@pytest.mark.parametrize("world", [1, 2, 4])
def test_each_ranks_draws_are_rows_of_the_single_draws(world):
    batch, width, height = 16, 23, 17

    def draws():
        gen = torch.Generator().manual_seed(5)
        us, vs = draw_pixel_batch(gen, batch, width, height)
        return us, vs, torch.rand((batch, 5), generator=gen), torch.rand((batch, 9), generator=gen)

    single = draws()
    covered = []
    for rank in range(world):
        rows = rank_rows(batch, rank, world)
        for got, want in zip(draws(), single):
            assert torch.equal(got[rows], want[rows.start : rows.stop])
        covered.extend(range(batch)[rows])
    assert covered == list(range(batch))


# ---------------------------------------------------- the step against JAX's mesh
@pytest.fixture(scope="module")
def jax_cases(scene):
    """Per family: the JAX trainer, the camera deltas and the rank task's
    case (config, weights, the JAX draws)."""
    key = jax.random.PRNGKey(7)
    cases = {}
    for family in FAMILIES:
        cfg = family_config(scene, family, optimize_camera=True, grad_accum=2)
        jtr = jconfig.instantiate(cfg["trainer"], global_config=cfg)
        deltas = np.zeros(np.shape(jtr.camera_deltas), np.float32)
        deltas[CAMERA] = DELTA
        state = {k: v.numpy() for k, v in params_from_jax(jtr.params).items()}
        draws = [x.numpy() for x in _jax_draws(jtr, key)]
        draws[:2] = [x.astype(np.int64) for x in draws[:2]]
        case = {"cfg": cfg, "state": state, "deltas": deltas, "iteration": ITERATION,
                "camera": CAMERA, "draws": draws}
        cases[family] = (jtr, key, case)
    return cases


@pytest.fixture(scope="module")
def background_ranks(jax_cases, tmp_path_factory):
    """The rank tasks of this file, started together: the steps and the
    renders."""
    cases = []
    for _, _, case in jax_cases.values():
        cfg = {**case["cfg"], "trainer": {**case["cfg"]["trainer"], "mesh": MESH2}}
        cases.append({**case, "cfg": cfg})
    runs = {"grads": start_ranks("grads", {"cases": cases}, tmp_path_factory.mktemp("grads")),
            "render": start_ranks("render", RENDER_INPUTS, tmp_path_factory.mktemp("render"))}
    yield {name: outputs for name, (_, outputs) in runs.items()}
    for ranks, _ in runs.values():
        ranks.stop()


@pytest.fixture(scope="module")
def sharded_steps(jax_cases, background_ranks):
    """Per family: the JAX package's sharded step on a 2-device mesh, the
    port's single-process step, and the port's at 2 gloo ranks, all on the
    JAX draws and weights."""
    want, single = {}, {}
    for family, (jtr, key, case) in jax_cases.items():
        local = make_local_grads(jtr.neural_render, jtr.loss_functions, jtr.calib,
                                 jtr.dataset.image_width, jtr.dataset.image_height,
                                 jtr.batch_size, grad_accum=2, optimize_camera=True)
        grads_fn = jax.jit(jmake_sharded_grads(make_mesh(2), local, jtr.batch_size))
        # host copies: the sharded program places them over its mesh
        loss, loss_dict, mse, grads, grads_cam = grads_fn(*jax.device_get((
            jtr.params, case["deltas"], jtr.rgb_images, jtr.mask_images, jtr.camera_initials,
            key, jnp.int32(CAMERA), jnp.int32(ITERATION))))
        want[family] = {"loss": float(loss), "mse": float(mse),
                        "loss_dict": {k: float(v) for k, v in loss_dict.items()},
                        "grads": _flat_grads(grads), "camera": np.asarray(grads_cam)}

        ttr = tconfig.instantiate(case["cfg"]["trainer"], global_config=case["cfg"])
        ttr.neural_render.load_state_dict(
            {k: torch.from_numpy(v) for k, v in case["state"].items()})
        with torch.no_grad():
            ttr.camera_deltas.copy_(torch.from_numpy(case["deltas"]))
        ttr.iteration = ITERATION
        loss, loss_dict, mse = ttr.step_grads(
            CAMERA, *(torch.from_numpy(x) for x in case["draws"]))
        single[family] = {
            "loss": loss.item(), "mse": mse.item(),
            "loss_dict": {k: v.item() for k, v in loss_dict.items()},
            "grads": {n: p.grad.numpy().copy() for n, p in ttr.neural_render.named_parameters()},
            "camera": ttr.camera_deltas.grad.numpy().copy()}
    ranks = background_ranks["grads"]()
    return want, single, {f: [r[i] for r in ranks] for i, f in enumerate(FAMILIES)}


def _hold(got: dict, want: dict, tol: float, what: str, camera_tol: float = TOL) -> None:
    assert set(got["loss_dict"]) == set(want["loss_dict"]), what
    for k in ("loss", "mse"):
        assert rel_to_norm(got[k], want[k]) <= tol, (what, k, got[k], want[k])
    for k, v in want["loss_dict"].items():
        assert rel_to_norm(got["loss_dict"][k], v) <= tol, (what, k, got["loss_dict"][k], v)
    assert set(got["grads"]) == set(want["grads"]), what
    for name, g in want["grads"].items():
        assert rel_to_norm(got["grads"][name], g) <= tol, (what, name)
    assert np.abs(want["camera"][CAMERA]).max() > 0, what
    assert rel_to_norm(got["camera"], want["camera"]) <= camera_tol, (
        what, got["camera"][CAMERA], want["camera"][CAMERA])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_step_matches_the_jax_mesh_and_the_single_step(sharded_steps, family):
    want, single, ranks = sharded_steps
    for rank, got in enumerate(ranks[family]):
        _hold(got, want[family], TOL, f"{family} rank {rank} vs the JAX mesh", CAMERA_JAX_TOL)
        _hold(got, single[family], TOL, f"{family} rank {rank} vs one process")
    # every rank ends with the same gradients and metrics
    a, b = ranks[family]
    assert a["loss"] == b["loss"] and a["loss_dict"] == b["loss_dict"]
    for name in a["grads"]:
        np.testing.assert_array_equal(a["grads"][name], b["grads"][name], err_msg=name)
    np.testing.assert_array_equal(a["camera"], b["camera"])
    # only the trained camera's row moves
    assert np.all(np.delete(a["camera"], CAMERA, axis=0) == 0.0)


# --------------------------------------------------------------- the validation
def _jax_error(fn) -> str:
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_validation_errors_are_the_jax_packages(scene):
    """batch % data and the per-rank batch % grad_accum (batch 8 / data 4 /
    accum 8), in the trainer and in the library's step."""
    for trainer in ({"batch_size": 10, "mesh": {"data": 4, "model": 1}},
                    {"batch_size": 8, "grad_accum": 8, "mesh": {"data": 4, "model": 1}}):
        cfg = family_config(scene, "neddf", **trainer)
        want = _jax_error(lambda: jconfig.instantiate(cfg["trainer"], global_config=cfg))
        with pytest.raises(ValueError) as err:
            tconfig.instantiate(cfg["trainer"], global_config=cfg)
        assert str(err.value) == want
    # the library step: the JAX package's local_grads at its trace-time check
    cfg = family_config(scene, "neddf")
    jtr = jconfig.instantiate(cfg["trainer"], global_config=cfg)
    local = make_local_grads(jtr.neural_render, jtr.loss_functions, jtr.calib, 16, 16, 8,
                             grad_accum=8)
    want = _jax_error(lambda: local(*(None,) * 8, 0, 2))
    with pytest.raises(ValueError) as err:
        check_local_grad_accum(8, check_world_batch(8, 4), 8)
    assert str(err.value) == want
    with pytest.raises(ValueError, match="not divisible by mesh data axis 4"):
        check_world_batch(10, 4)


# ------------------------------------------------------------------ the render
def _sphere_values(resolution=32, radius=0.4, cube_range=1.1):
    line = (np.arange(resolution) + 0.5) / resolution * 2 * cube_range - cube_range
    xs, ys, zs = np.meshgrid(line, line, line, indexing="ij")
    return ((xs**2 + ys**2 + zs**2) < radius**2).astype(np.float32)


RENDER_CASES = [(40, False), (7, False), (7, True)]
RENDER_INPUTS = {
    "network": {"_target_": "neddf_tpu.fields.NeDDF", "embed_pos_rank": 4, "embed_dir_rank": 2,
                "ddf_layer_count": 4, "ddf_layer_width": 16, "col_layer_count": 3,
                "col_layer_width": 16, "skips": (1,), "d_near": 0.001,
                "compute_dtype": "float32"},
    "seed": 2,
    "camera": (np.array([300.0, 300.0, 128.0, 112.0], np.float32), np.eye(3, dtype=np.float32),
               np.array([0.0, 0.0, 4.0], np.float32)),
    "grid": _sphere_values(), "downsampling": 16, "cases": RENDER_CASES,
}


@pytest.fixture(scope="module")
def sharded_renders(background_ranks):
    return background_ranks["render"]()


@pytest.mark.parametrize("case", range(len(RENDER_CASES)),
                         ids=["chunk40", "chunk7_padded", "chunk7_ray_cull"])
def test_sharded_render_equals_the_single_process_render(sharded_renders, case):
    """288 pixels: chunks of 40 split evenly over 2 ranks but the last
    (8 rows); chunks of 7 are padded to 8. Under ray_cull some pixels are
    culled and the re-packed chunks go through the sharded render."""
    for rank, results in enumerate(sharded_renders):
        sharded, single = results[case]
        for k in ("color", "depth", "transmittance"):
            assert sharded[k].shape == single[k].shape == (16, 18, single[k].shape[2])
            np.testing.assert_allclose(sharded[k], single[k], rtol=0, atol=1e-5,
                                       err_msg=f"rank {rank} {k}")
            np.testing.assert_array_equal(sharded[k], sharded_renders[0][case][0][k])
    if RENDER_CASES[case][1]:
        transmittance = sharded_renders[0][case][1]["transmittance"]
        assert 0 < np.sum(transmittance == 1.0) < transmittance.size  # some rays culled


# ------------------------------------------------------------ the launch device
def test_a_launch_on_a_device_that_is_not_current_raises(monkeypatch):
    """The runtime launches on the current device, so a launch with the
    tensors of another card must raise (a rank that skipped set_device)."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(RuntimeError, match="torch.cuda.set_device"):
        _build.stream(torch.device("cuda", 1))
