"""A fused plan that does not fit the shared memory routes the field away.

The fused kernels' plans (``kernels/dual_mlp.py::tile_fwd_plan``, the row-
tile forward; ``kernels/sdf_mlp.py::sweep_plan``, the NeuS sweep) depend on
the operand size, the input segments' widths (the positional encodings'
ranks), the post-skip layout and, for the sweep, E. Each module's
``kernel_refusal`` checks them where it is given those, so a field whose
plan does not fit takes the per-layer route (``fields/base.py::
per_layer_route``), which takes any width, depth and rank, and a direct
call of the fused wrapper raises NotImplementedError, never a plain
fallback.

On the CPU:

* the scan: NeDDF, NeRF and NeuS x ``embed_pos_rank`` 0-24 x widths {45,
  64, 100, 256, 300, 512} x f32 and bf16 (NeuS runs f32 only): a field's
  ``per_layer`` is True exactly where one of the plans its fused kernels
  launch raises, the plans made here from the field's layer shapes;
* the cases found by a scan of the plans: NeDDF with both trunks 512 wide
  in f32 from rank 11, NeDDF's K=3 trunk at 512 from rank 17, NeRF and
  NeuS at 512 from rank 22 take the route and one rank fewer does not;
  NeuS 512 at rank 13, where the sweep's earlier layout did not fit,
  keeps the fused route (the sweep's shared memory holds nothing E wide);
  bf16 fits at every rank of the scan;
* each module's argument check raises NotImplementedError ("shared
  memory") on such a configuration;
* NeDDF 512 f32 at rank 11 (two layers a trunk) on its route against the
  JAX package's ``fused="off"`` path: the training field's outputs within
  1e-5 of their largest magnitude (density and the penalties 1e-4, as
  ``tests/test_torch_train_field.py`` holds them) and every gradient
  within 1e-4.
"""
import numpy as np
import pytest
import torch

from neddf_tpu_torch.fields.neddf import NeDDF
from neddf_tpu_torch.fields.nerf import NeRF
from neddf_tpu_torch.fields.neus import NeuS
from neddf_tpu_torch.kernels import dual_mlp as tdm
from neddf_tpu_torch.kernels import mlp as tmlp
from neddf_tpu_torch.kernels import sdf_mlp as tsdf
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

RANKS = range(25)
WIDTHS = (45, 64, 100, 256, 300, 512)
DTYPES = {"float32": 4, "bfloat16": 2}


def _fits(*plans) -> bool:
    try:
        for make in plans:
            make()
    except ValueError:
        return False
    return True


def _field(family, rank, width, dtype):
    if family == "neddf":
        return NeDDF(embed_pos_rank=rank, ddf_layer_width=width, col_layer_width=width,
                     compute_dtype=dtype)
    if family == "nerf":
        return NeRF(embed_pos_rank=rank, layer_width=width, compute_dtype=dtype)
    return NeuS(embed_pos_rank=rank, sdf_layer_width=width, col_layer_width=width)


def _plans_fit(family, field, size) -> bool:
    """Whether every plan the field's fused kernels launch fits, from the
    field's own layers: layer 0's fan-in is the position encoding's width,
    a post-skip layer's fan-in beyond the width the skipped segment."""
    if family == "neddf":
        ddf, col = field.layers_ddf, field.layers_col
        pe, w, cw = ddf[0].w.shape[0], ddf[0].w.shape[1], col[0].w.shape[1]
        segs = [pe, field.embed_dir_rank * 6, 3, w]
        assert sum(segs) == col[0].w.shape[0]
        split = [tdm.SPLIT_SEG_FIRST if l.w.shape[0] > w and i else 0 for i, l in enumerate(ddf)]
        return _fits(lambda: tdm.tile_fwd_plan(size, 3, w, [pe], split),
                     lambda: tdm.tile_fwd_plan(size, 1, cw, segs, [0] * len(col)),
                     lambda: tdm.tile_fwd_plan(size, 0, cw, segs, [0] * len(col)))
    layers = field.layers if family == "nerf" else field.layers_sdf
    e, w = layers[0].w.shape
    split = [tdm.SPLIT_HIDDEN_FIRST if l.w.shape[0] > w and i else 0
             for i, l in enumerate(layers)]
    if family == "nerf":
        return _fits(lambda: tdm.tile_fwd_plan(size, 0, w, [e], split))
    col = field.layers_col
    segs = [3, field.embed_dir_rank * 6, 3, w]
    return _fits(lambda: tdm.tile_fwd_plan(4, 0, w, [e], split),
                 lambda: tsdf.sweep_plan(w, e, split),
                 lambda: tdm.tile_fwd_plan(4, 0, col[0].w.shape[1], segs, [0] * len(col),
                                           col[-1].w.shape[1]))


SCAN = [(f, d, w) for f in ("neddf", "nerf", "neus") for d in DTYPES for w in WIDTHS
        if f != "neus" or d == "float32"]


@pytest.mark.parametrize("family, dtype, width", SCAN)
def test_per_layer_exactly_where_a_fused_plan_raises(family, dtype, width):
    routed = []
    # (rank 0 gives NeRF's and NeuS's layer 0 no input, which their
    # initialisation, scaled by the fan-in, does not take)
    for rank in RANKS if family == "neddf" else RANKS[1:]:
        field = _field(family, rank, width, dtype)
        fits = _plans_fit(family, field, DTYPES[dtype])
        assert field.per_layer is (not fits), (family, dtype, width, rank)
        if not fits:
            routed.append(rank)
    if dtype == "bfloat16" or width < 300:
        assert routed == []  # bf16 only past rank 150
    elif width == 512:
        first = {"neddf": 11, "nerf": 22, "neus": 22}[family]
        assert routed == list(range(first, 25))


@pytest.mark.parametrize("family, rank, per_layer", [
    ("neddf", 10, False), ("neddf", 11, True), ("nerf", 21, False), ("nerf", 22, True),
    ("neus", 13, False), ("neus", 21, False), ("neus", 22, True)])
def test_the_named_cases(family, rank, per_layer):
    assert _field(family, rank, 512, "float32").per_layer is per_layer


def test_the_k3_trunk_alone_from_rank_17():
    def trunk(rank):  # a narrow colour trunk: only the K=3 trunk's plan can refuse
        return NeDDF(embed_pos_rank=rank, ddf_layer_width=512, col_layer_width=64,
                     compute_dtype="float32")

    assert not trunk(16).per_layer and trunk(17).per_layer
    assert tdm.kernel_refusal("tanhExp", 512, 7, 3, itemsize=4, seg_widths=[102],
                              layout=trunk(17).trunk_layout).startswith("shared memory")
    # the same trunk without the plan's inputs: only the width and the depth
    assert tdm.kernel_refusal("tanhExp", 512, 7, 3) is None
    # the sweep's plan fits at rank 13 (E = 78) and takes the same bytes as at E = 3
    split = [tdm.SPLIT_HIDDEN_FIRST if li == 5 else 0 for li in range(8)]
    assert tsdf.sweep_plan(512, 78, split)["smem"] == tsdf.sweep_plan(512, 3, split)["smem"]


def test_the_fused_wrappers_refuse_what_their_plans_do_not_fit():
    """Each module's argument check raises NotImplementedError on a plan
    that does not fit, after the shapes are checked (CPU tensors: the
    checks alone, no launch)."""
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32)

    w = 512
    # NeRF's trunk from rank 22: [h, seg0] with seg0 132 wide
    e = t(5, 132)
    layout = tuple(li == 5 for li in range(8))
    ws = [t(132, w)] + [t(w + 132 * s, w) for s in layout[1:]]
    bs = [t(w) for _ in ws]
    with pytest.raises(NotImplementedError, match="shared memory"):
        tmlp._check_kernel_args([e], ws, bs, layout, "ReLU")
    with pytest.raises(NotImplementedError, match="shared memory"):
        tsdf._check_kernel_args(e, ws, bs, layout, "ReLU")
    # NeDDF's K=1 colour trunk from rank 11: segments 66, 24, 3, 512
    segs = [t(5, n) for n in (66, 24, 3, w)]
    cws = [t(605, w), t(w, w)]
    cbs = [t(w), t(w)]
    with pytest.raises(NotImplementedError, match="shared memory"):
        tdm._check_seg_args(segs, [t(1, 5, 66), t(1, 5, w)], cws, cbs, (False, False),
                            "tanhExp", (True, False, False, True), 1)
    # a shape error still reads as one (the checks come before the plan)
    with pytest.raises(ValueError):
        tmlp._check_kernel_args([e], ws[:-1] + [t(3, w)], bs, layout, "ReLU")
    # one rank fewer fits
    e = t(5, 126)
    ws = [t(126, w)] + [t(w + 126 * s, w) for s in layout[1:]]
    tmlp._check_kernel_args([e], ws, bs, layout, "ReLU")
    tsdf._check_kernel_args(e, ws, bs, layout, "ReLU")


# ------------------------------------------------- the route against JAX
REFUSED_FIELD = dict(embed_pos_rank=11, embed_dir_rank=4, ddf_layer_count=3,
                     ddf_layer_width=512, col_layer_count=3, col_layer_width=512,
                     activation_type="tanhExp", density_activation_type="ReLU",
                     compute_dtype="float32")
KEYS = ("distance", "density", "color", "fields_penalty", "aux_grad")
TOL = {"distance": 1e-5, "color": 1e-5, "aux_grad": 1e-5, "density": 1e-4,
       "fields_penalty": 1e-4}


def _close(got, ref, bound, what=""):
    ref = np.asarray(ref, np.float32)
    err = np.abs(np.asarray(got, np.float32) - ref).max()
    assert err <= bound * max(np.abs(ref).max(), 1e-6), (what, err, np.abs(ref).max())


def test_refused_neddf_takes_the_route_and_matches_jax():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from neddf_tpu.fields.neddf import NeDDF as JNeDDF
    from neddf_tpu.geometry.rays import Sampling as JSampling
    from neddf_tpu_torch.geometry.rays import Sampling
    from neddf_tpu_torch.training.checkpoint import params_from_jax
    from tests.test_torch_train_field import _flat_grads, _sampling

    jfield = JNeDDF(**REFUSED_FIELD, fused="off")
    params = jfield.init(jax.random.PRNGKey(11))
    field = NeDDF(**REFUSED_FIELD)
    field.load_state_dict(params_from_jax(params), strict=True)
    assert field.per_layer
    pos, d, var = _sampling(b=2, s=6, seed=11)
    jsamp = JSampling(jnp.asarray(pos), jnp.asarray(d), jnp.asarray(var))
    sched = 2000
    ref = jfield.apply(params, jsamp, jfield.schedule(sched), need_aux=True)
    walks = tdm.layer_fwd_plain.calls, tdm.dual_mlp_seg_plain.calls
    got = field(Sampling(*map(torch.from_numpy, (pos, d, var))), field.schedule(sched),
                need_aux=True)
    # the per-layer walk ran (on the CPU its plain launcher), no fused plain trunk
    assert tdm.layer_fwd_plain.calls > walks[0] and tdm.dual_mlp_seg_plain.calls == walks[1]
    for k in KEYS:
        _close(got[k].detach().numpy(), ref[k], TOL[k], k)
    rng = np.random.default_rng(12)
    weights = {k: rng.normal(size=np.shape(ref[k])).astype(np.float32) for k in KEYS}

    def jloss(p):
        out = jfield.apply(p, jsamp, jfield.schedule(sched), need_aux=True)
        return sum(jnp.sum(out[k] * weights[k]) for k in KEYS)

    jgrads = _flat_grads(jax.grad(jloss)(params))
    sum(torch.sum(got[k] * torch.from_numpy(weights[k])) for k in KEYS).backward()
    for name, p in field.named_parameters():
        _close(p.grad.numpy(), jgrads[name], 1e-4, name)
