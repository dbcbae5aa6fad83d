"""The port's optimizer state against the JAX package's, on the CPU.

* ``RowSparseAdam`` (``training/optim.py``) against the JAX package's
  ``row_sparse_adam`` on the cases of ``tests/training/test_optim.py``
  (zero-gradient rows untouched, a row visited every step, rows visited
  in turns) and a row whose gradient turns NaN: updates, moments and
  visit counts.
* torch Adam's state in optax's layout (``checkpoint.adam_to_optax``):
  the same tree as ``flax.serialization.to_state_dict`` of the JAX
  trainer's ``opt_state``, with and without weight decay (its
  ``add_decayed_weights`` shifts the chain), and back
  (``adam_from_optax``) bitwise.
* k optax updates carried into the port, then the next update equal to
  optax's.

Tolerances (f32 on both sides): row-sparse updates within 1e-7 absolute
(a step moves a parameter by about lr); parameters after the carried
update within 1e-6 (lr = 5e-4), as ``test_torch_train_step.py`` holds
three Adam steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from neddf_tpu.training.optim import row_sparse_adam
from neddf_tpu_torch import config as tconfig
from neddf_tpu_torch.training.checkpoint import (
    adam_from_optax,
    adam_to_optax,
    params_from_jax,
)
from neddf_tpu_torch.training.optim import RowSparseAdam
from tests.test_torch_train_field import _flat_grads
from tests.test_torch_train_step import (  # noqa: F401  (scene is a fixture)
    _jax_draws,
    _jax_grads,
    _trainers,
    scene,
    tiny_config,
)
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)


def _grad_sequence(case, rng):
    """(shape, [grads]) of one case, drawn with numpy."""
    if case == "zero_grad_rows":
        g = np.zeros((3, 6), np.float32)
        g[1] = 1.0
        return (3, 6), [g] * 5
    if case == "dense_row":
        return (1, 4), list(rng.normal(size=(7, 1, 4)).astype(np.float32))
    seq = rng.normal(size=(6, 6)).astype(np.float32)
    grads = []
    for i in range(6):
        g = np.zeros((2, 6), np.float32)
        g[i % 2] = seq[i]
        if case == "nan_row" and i == 3:
            g[1, 2] = np.nan
        grads.append(g)
    return (2, 6), grads


@pytest.mark.parametrize("case", ["zero_grad_rows", "dense_row", "round_robin", "nan_row"])
def test_row_sparse_adam_matches_jax(case):
    shape, grads = _grad_sequence(case, np.random.default_rng(0))
    lr = 0.01
    tx = row_sparse_adam(lr)
    jp = jnp.zeros(shape, jnp.float32)
    js = tx.init(jp)
    tp = torch.zeros(shape, dtype=torch.float32)
    opt = RowSparseAdam([tp], lr=lr)
    for g in grads:
        updates, js = tx.update(jnp.asarray(g), js)
        jp = optax.apply_updates(jp, updates)
        tp.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-7,
                                   equal_nan=True)
    state = opt.state[tp]
    np.testing.assert_array_equal(state["t"].numpy(), np.asarray(js.t))
    for k in ("m", "v"):
        np.testing.assert_allclose(state[k].numpy(), np.asarray(getattr(js, k)), rtol=1e-6,
                                   atol=1e-9, equal_nan=True)
    if case == "zero_grad_rows":
        assert np.all(tp.numpy()[[0, 2]] == 0.0) and np.all(state["m"].numpy()[[0, 2]] == 0.0)
    if case == "nan_row":  # the NaN row surfaces, the other row stays finite
        assert np.isnan(tp.numpy()[1]).any() and np.isfinite(tp.numpy()[0]).all()
        assert state["t"].tolist() == [3, 3]


def _optax_tree(opt_state):
    return jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(opt_state))


def _assert_same_tree(got, want, path="opt_state"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}.{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (path, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=path)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-3], ids=["plain", "decayed"])
def test_adam_state_in_the_optax_layout_round_trips(scene, weight_decay):
    """Two steps on the same draws and gradients in both packages: the
    port's state in optax's layout is the JAX trainer's tree (keys,
    shapes, dtypes, values), and it loads back bitwise."""
    jtr, grads_fn, ttr = _trainers(tiny_config(scene, optimizer_weight_decay=weight_decay))
    params, opt_state = jtr.params, jtr.tx.init(jtr.params)
    for step, cam in enumerate((0, 1)):
        key = jax.random.PRNGKey(200 + step)
        _, _, _, grads, _ = _jax_grads(jtr, grads_fn, key, cam, step, params)
        updates, opt_state = jtr.tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for group in ttr.optimizer.param_groups:
            group["lr"] = ttr.learning_rate(ttr.iteration)
        us, vs, u_strat, u_pdf = _jax_draws(jtr, key)
        ttr.step_grads(cam, us.long(), vs.long(), u_strat, u_pdf)
        ttr.optimizer.step()
        ttr.iteration += 1
    named = list(ttr.neural_render.named_parameters())
    tree = adam_to_optax(ttr.optimizer, named, weight_decay != 0)
    _assert_same_tree(tree, _optax_tree(opt_state))

    fresh = tconfig.instantiate(ttr.config["trainer"], global_config=ttr.config)
    fresh_named = list(fresh.neural_render.named_parameters())
    adam_from_optax(tree, fresh.optimizer, fresh_named)
    for (name, p), (_, q) in zip(named, fresh_named):
        a, b = ttr.optimizer.state[p], fresh.optimizer.state[q]
        assert float(a["step"]) == float(b["step"]) == 2.0
        assert b["step"].dtype == a["step"].dtype and b["step"].device == a["step"].device
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a[k], b[k]), (name, k)


@pytest.mark.parametrize("k", [1, 3])
def test_update_after_carried_optax_state_matches_optax(scene, k):
    """k optax updates in the JAX package, carried into the port (params,
    opt_state, iteration), then one more update in each package."""
    jtr, grads_fn, ttr = _trainers(tiny_config(scene, scheduler_lr=0.5))
    params, opt_state = jtr.params, jtr.tx.init(jtr.params)
    cams = (0, 1, 1, 0)
    for step in range(k):
        key = jax.random.PRNGKey(300 + step)
        _, _, _, grads, _ = _jax_grads(jtr, grads_fn, key, cams[step], step, params)
        updates, opt_state = jtr.tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

    ttr.neural_render.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    adam_from_optax(_optax_tree(opt_state), ttr.optimizer,
                    list(ttr.neural_render.named_parameters()))
    ttr.iteration = k

    key = jax.random.PRNGKey(300 + k)
    _, _, _, grads, _ = _jax_grads(jtr, grads_fn, key, cams[k], k, params)
    updates, opt_state = jtr.tx.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    for group in ttr.optimizer.param_groups:
        group["lr"] = ttr.learning_rate(ttr.iteration)
    us, vs, u_strat, u_pdf = _jax_draws(jtr, key)
    ttr.step_grads(cams[k], us.long(), vs.long(), u_strat, u_pdf)
    ttr.optimizer.step()
    ref = _flat_grads(params)
    for name, p in ttr.neural_render.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name], rtol=0, atol=1e-6,
                                   err_msg=name)
