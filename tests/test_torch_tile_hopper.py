"""The row-tile forward on Hopper (``csrc/tile_hopper.cuh``: every layer of
a trunk chained in shared memory on wgmma, the weights by TMA).

On the CPU: ``dual_mlp.tile_fwd_plan`` (rows per tile, ring stages, warp
roles, shared bytes; the kernel's launcher works out the same and refuses
a call whose plan differs) at every configuration the fields reach, under
both operand types and the width classes 64-512; the plain twin of the
f32 pre-pass (``tile_wt_planes_plain``: every layer's W^T as tf32 hi and
lo planes) against numpy; the tile's row order (``tile_row_order``).

On the card (marked ``cuda``: they skip without one): the kernel against
its plain version over the widths 1-512, K = 0, 1, 3, the five
activations, both post-skip orders, a narrow last layer, the stash on and
off, and rows from 1 to 99,328.

Tolerances, as ``tests/test_torch_tc_kernels.py`` holds the mma.sync body
this kernel replaces: f32 1e-4 of the largest magnitude (3xTF32 leaves
about 2^-21 of each product, and the f32 sums run in another order); bf16
2^-5 (a value on a rounding boundary may round the other way and carry
one bf16 step on). Under ReLU and LeakyReLU with tangents, f' steps at 0
and a pre-activation within a rounding of 0 may take the other side in
the kernel than in the plain pass: there the kernel is held against the
plain layers replayed over its own stash (``chip_smoke.dual_replay``).
"""
import numpy as np
import pytest
import torch

from neddf_tpu_torch.kernels import dual_mlp as tdm
from neddf_tpu_torch.kernels import mlp as tmlp
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

SEG, HID = tdm.SPLIT_SEG_FIRST, tdm.SPLIT_HIDDEN_FIRST
ITEMSIZE = {"bfloat16": 2, "float32": 4}
CLASSES = (64, 128, 256, 512)


def _split(n_layers, at, code):
    return tuple(code if li == at else 0 for li in range(n_layers))


# the trunks the fields build at a width W (fields/neddf.py, nerf.py,
# neus.py; chip_smoke.path_geo): (K, layer-0 segments, split per layer,
# last width)
FIELD_CONFIGS = {
    "neddf_trunk": lambda w: (3, (60,), _split(8, 5, SEG), w),
    "neddf_color": lambda w: (1, (60, 24, 3, w), _split(4, -1, 0), w),
    "eval_color": lambda w: (0, (60, 24, 3, w), _split(4, -1, 0), w),
    "nerf_trunk": lambda w: (0, (60,), _split(8, 5, HID), w),
    "neus_sdf": lambda w: (0, (36,), _split(8, 5, HID), w),
    "neus_color": lambda w: (0, (3, 24, 3, w), _split(9, -1, 0), 3),
}


@pytest.mark.parametrize("dtype", list(ITEMSIZE))
@pytest.mark.parametrize("width", CLASSES)
@pytest.mark.parametrize("field", list(FIELD_CONFIGS))
def test_plan_fits_every_field_configuration(field, width, dtype):
    k, segs, split, last = FIELD_CONFIGS[field](width)
    e = ITEMSIZE[dtype]
    p = tdm.tile_fwd_plan(e, k, width, segs, split, last, m=99_328)
    s = k + 1
    assert p["class"] == width and p["nc"] == min(width, 128)
    assert p["smem"] <= tdm.TILE_FWD_SMEM
    assert p["rows"] == 64 and p["rows"] % s == 0 and p["points"] * s == p["rows"]
    assert p["consumers"] in (1, 2) and p["threads"] == 128 * (p["consumers"] + 1)
    assert p["warps"] == {"consumer": 4 * p["consumers"], "producer": 1, "idle": 3}
    assert 2 <= p["stages"] <= 6 and (p["consumers"] == 1 or p["stages"] >= 3)
    # two buffers for a layer wider than one chunk, else one in place; a
    # parked output only where two f32 buffers of 512 columns cannot fit
    assert p["park"] == (e == 4 and width == 512)
    assert (p["kb"]["b"] > 0) == (width > p["nc"] and not p["park"])
    bk = 128 // e
    assert p["kb"]["a"] * bk >= width and p["kb"]["seg"] * bk >= (segs[0] if any(split) else 0)
    if not (any(split) and len(segs) == 1):
        # layer 0's input shares region A, each segment from a k-block of its own
        assert p["kb"]["a"] >= sum(-(-w // bk) for w in segs)
    assert p["f_bytes"] == (-(-64 * (p["nc"] + 4) // 1024) * 1024 if s == 4 else 0)
    region = (p["kb"]["seg"] + p["kb"]["a"] + p["kb"]["b"]) * 64 * 128 + p["f_bytes"]
    stages = p["stages"] * p["stage_bytes"] + (2 * p["stages"] + 2) * 8
    assert p["smem"] == p["consumers"] * region + stages
    assert p["chunks"] == [-(-width // p["nc"])] * (len(split) - 1) + [-(-last // p["nc"])]
    if e == 4:
        assert p["kp"] % 32 == 0 and p["scratch_bytes"] >= len(split) * 2 * width * p["kp"] * 4
    else:
        assert p["kp"] == 0 and p["scratch_bytes"] == 0
    assert p["tma"][-1] == (e == 4 or last * e % 16 == 0)
    assert p["ints"] == (64, p["consumers"], p["stages"], p["smem"], int(p["park"]), p["kp"],
                         p["grid"], p["scratch_bytes"])


def test_plan_of_the_shipped_steps():
    """The shipped trunks at width 256: two row tiles a block beside the
    producer in bf16 (the ping-pong), one in f32 (two 64 KB buffers of h
    a tile); what a block reads of W from L2 per row tile."""
    def plan(name, e, m):
        k, segs, split, last = FIELD_CONFIGS[name](256)
        return tdm.tile_fwd_plan(e, k, 256, segs, split, last, m=m)

    plans = {name: plan(name, e, m)
             for name, e, m in (("neddf_trunk", 2, 99_328), ("neddf_color", 2, 99_328),
                                ("eval_color", 2, 198_656), ("nerf_trunk", 2, 198_656),
                                ("neus_color", 4, 265_216), ("neus_sdf", 4, 265_216))}
    got = {name: (p["consumers"], p["stages"], p["smem"]) for name, p in plans.items()}
    assert got == {"neddf_trunk": (2, 4, 231_504), "neddf_color": (2, 3, 229_440),
                   "eval_color": (2, 3, 229_440), "nerf_trunk": (2, 5, 229_472),
                   "neus_color": (1, 2, 221_232), "neus_sdf": (1, 2, 213_040)}
    # bf16 K=3: 8 layers of 256 columns, half a 16 KB stage per tile of 64 rows
    assert plans["neddf_trunk"]["w_l2_bytes"] == (1 + 6 * 4 + 5) * 2 * 16_384 // 2
    assert all(p["grid"] == tdm.H100_SMS for p in plans.values())


def test_plan_grid_scratch_and_refusals():
    one = tdm.tile_fwd_plan(2, 3, 256, (60,), _split(8, 5, SEG), m=1)
    assert one["grid"] == 1 and one["ints"][6] == 1
    park = tdm.tile_fwd_plan(4, 0, 512, (36,), _split(8, 5, HID), m=10_000)
    assert park["park"] and park["scratch_bytes"] > 8 * 2 * 512 * park["kp"] * 4
    assert park["scratch_bytes"] == (-(-8 * 2 * 512 * park["kp"] * 4 // 256) * 256
                                     + park["grid"] * 64 * 512 * 4)
    with pytest.raises(ValueError, match="shared memory"):
        tdm.tile_fwd_plan(4, 3, 512, (512, 512, 512, 512), (0, 0))
    with pytest.raises(ValueError):
        tdm.tile_fwd_plan(2, 2, 256, (60,), (0, 0))
    with pytest.raises(ValueError):
        tdm.tile_fwd_plan(2, 0, 513, (60,), (0, 0))
    with pytest.raises(ValueError):
        tdm.tile_fwd_plan(2, 0, 256, (60,), (0,) * 13)


@pytest.mark.parametrize("streams", (1, 2, 4))
def test_row_order_round_trips(streams):
    order = tdm.tile_row_order(streams)
    points = 64 // streams
    assert sorted(order) == [(p, s) for p in range(points) for s in range(streams)]
    for r, (p, s) in enumerate(order):
        assert r == (p // 8) * 8 * streams + 8 * s + p % 8
        if streams > 1 and r % 16 < 8:
            # a thread's accumulator rows r and r + 8: streams s, s + 1 of a point
            assert order[r + 8] == (p, s + 1) and s % 2 == 0


def _tf32_numpy(x):
    bits = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("name", ["sdf_hidden_first", "seg_first", "color_narrow_last"])
def test_wt_planes_plain_matches_numpy(name):
    """The f32 pre-pass's plain twin: W^T's rows each piece (each layer-0
    segment, each post-skip piece) from a k-block of 32 of its own, zero
    between, tf32 hi and lo summing to W within 2^-21 of each value."""
    segs, split, width, last = {
        "sdf_hidden_first": ((36,), _split(4, 2, HID), 64, 64),
        "seg_first": ((60,), _split(3, 1, SEG), 100, 100),
        "color_narrow_last": ((3, 24, 3, 40), _split(3, -1, 0), 40, 3)}[name]
    rng = np.random.default_rng(5)
    x0w, w0 = sum(segs), segs[0]
    fans = [x0w] + [width + w0 if s else width for s in split[1:]]
    outs = [width] * (len(split) - 1) + [last]
    ws = [rng.normal(size=(f, o)).astype(np.float32) for f, o in zip(fans, outs)]
    got = tdm.tile_wt_planes_plain([torch.from_numpy(w) for w in ws], segs, split).numpy()
    # numpy: the pieces in the order of W's rows, each from a k-block of 32
    kps = []
    planes = []
    for li, w in enumerate(ws):
        if li == 0:  # each segment from a k-block of its own
            pieces = [(sum(segs[:i]), w) for i, w in enumerate(segs)]
        elif split[li] == SEG:
            pieces = [(0, w0), (w0, width)]
        elif split[li] == HID:
            pieces = [(0, width), (width, w0)]
        else:
            pieces = [(0, width)]
        cols, k = [], 0
        for row, n in pieces:
            block = np.zeros((width, -(-n // 32) * 32), np.float32)
            block[: w.shape[1], :n] = w[row: row + n].T
            cols.append(block)
        planes.append(np.concatenate(cols, axis=1))
        kps.append(planes[-1].shape[1])
    kp = max(kps)
    ref = np.zeros((len(ws), 2, width, kp), np.float32)
    for li, wt in enumerate(planes):
        hi = _tf32_numpy(wt)
        ref[li, 0, :, : wt.shape[1]] = hi
        ref[li, 1, :, : wt.shape[1]] = _tf32_numpy(wt - hi)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    whole = got[:, 0].astype(np.float64) + got[:, 1]
    for li, wt in enumerate(planes):
        err = np.abs(whole[li, :, : wt.shape[1]] - wt).max()
        assert err <= 2.0**-21 * np.abs(wt).max()


# ------------------------------------------------------------------ the card
TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-5}
KINK = ("ReLU", "LeakyReLU")
ACTS = ("tanhExp", "ReLU", "LeakyReLU", "Softplus", "Sigmoid")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


def _err(got, ref):
    return (got.float() - ref.float()).abs().max().item() / max(
        ref.float().abs().max().item(), 1e-30)


def _layers(rng, fans, outs, dtype, dev):
    ws = [torch.tensor(rng.normal(scale=1.5 * f ** -0.5, size=(f, o)), dtype=dtype, device=dev)
          for f, o in zip(fans, outs)]
    bs = [torch.tensor(rng.normal(scale=0.1, size=o), dtype=torch.float32, device=dev)
          for o in outs]
    return ws, bs


def _run(k, width, act, dtype, m, stash=True, last=None, seed=0):
    """One call of the tile forward (K=3: dual_mlp_trunk over one segment
    with [seg0, h] at layer 5 of 7; K=1: dual_mlp_seg over four segments,
    the last at most 256 wide, with [seg0, h] at layer 2 of 3 (at 512 a
    599-wide layer-0 input and a post-skip copy of segment 0 would not fit
    shared memory beside an f32 tile: no field builds that); K=0: mlp_seg
    over one segment with [h, seg0] at layer 2 of 5 and a last layer
    ``last`` wide) and the plain version's; [(kernel, plain), ...] over
    the outputs and the stash."""
    dev = _card()
    rng = np.random.default_rng(seed + width)
    if k == 3:
        segs, has_j, lay = (60,), (True,), tuple(li == 5 for li in range(7))
    elif k == 1:
        segs, has_j = (60, 24, 3, min(width, 256)), (True, False, False, True)
        lay = (False, False, True)
    else:
        segs, lay = (60,), (False, False, True, False, False)
    vs = [torch.tensor(rng.normal(size=(m, w)), dtype=dtype, device=dev) for w in segs]
    before = dict(tdm.TILE_LAUNCHES)
    if k:
        js = [torch.tensor(rng.normal(scale=0.5, size=(k, m, w)), dtype=dtype, device=dev)
              for w, h in zip(segs, has_j) if h]
        fans = [sum(segs)] + [segs[0] + width if s else width for s in lay[1:]]
        ws, bs = _layers(rng, fans, [width] * len(lay), dtype, dev)
        if k == 3:
            got = tdm.dual_mlp_trunk(vs[0], js[0], ws, bs, lay, act, stash=stash)
        else:
            got = tdm.dual_mlp_seg(vs, js, ws, bs, lay, act, has_j, k, stash=stash)
        ref = tdm.dual_mlp_seg_plain(vs, js, ws, bs, lay, act, has_j, k, stash=True)
        if act in KINK and stash:
            import chip_smoke

            ref = chip_smoke.dual_replay(torch, vs, js, ws, bs, lay, act, has_j, k, got[2])
            ref = [ref[0], ref[1], ref[2:]]
        kernel = [got[0], got[1], *(got[2] if stash else [])]
        plain = [ref[0], ref[1], *(ref[2] if stash else [])]
    else:
        last = width if last is None else last
        fans = [sum(segs)] + [width + segs[0] if s else width for s in lay[1:]]
        ws, bs = _layers(rng, fans, [width] * (len(lay) - 1) + [last], dtype, dev)
        got = tmlp.mlp_seg(vs, ws, bs, lay, act, stash=stash)
        ref = tmlp.mlp_seg_plain(vs, ws, bs, lay, act, stash=True)
        kernel = [got[0], *got[1]] if stash else [got]
        plain = [ref[0], *ref[1]] if stash else [ref[0]]
    key = "tc" if dtype == torch.bfloat16 else "tf32x3"
    assert tdm.TILE_LAUNCHES[key] == before[key] + (1 if m else 0)
    return list(zip(kernel, plain))


def _hold(pairs, dtype):
    for got, ref in pairs:
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert torch.isfinite(got.float()).all()
        assert _err(got, ref) <= TOL[dtype], _err(got, ref)


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", (0, 1, 3))
@pytest.mark.parametrize("width", (1, 45, 64, 100, 128, 200, 256, 300, 512))
def test_cuda_tile_widths(width, k, dtype):
    """Every width class, widths off 16-byte rows (the producer's own
    loads in bf16), both post-skip orders, K = 0, 1, 3, over three tiles
    and a ragged edge."""
    dt = DTYPES[dtype]
    _hold(_run(k, width, "tanhExp", dt, 3 * 64 // (k + 1) + 5), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", (0, 1, 3))
@pytest.mark.parametrize("act", ACTS)
def test_cuda_tile_activations(act, k, dtype):
    dt = DTYPES[dtype]
    _hold(_run(k, 256, act, dt, 1000), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rows", ("one", "tile-1", "tile+1", "99328"))
def test_cuda_tile_rows(rows, dtype):
    """M from one point to the K=3 trunk's 99,328 (a tile is 16 points)."""
    dt = DTYPES[dtype]
    m = {"one": 1, "tile-1": 15, "tile+1": 17, "99328": 99_328}[rows]
    _hold(_run(3, 256, "tanhExp", dt, m), dt)
    _hold(_run(0, 256, "tanhExp", dt, m, last=3), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("last", (1, 3, 8, 130))
def test_cuda_tile_narrow_last_layer(last, dtype):
    dt = DTYPES[dtype]
    _hold(_run(0, 256, "ReLU", dt, 777, last=last), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", (0, 1, 3))
def test_cuda_tile_stash_off_is_bitwise(k, dtype):
    """Without the stash the outputs are the same bits."""
    dt = DTYPES[dtype]
    with_stash = _run(k, 200, "Softplus", dt, 999, stash=True, seed=3)
    without = _run(k, 200, "Softplus", dt, 999, stash=False, seed=3)
    for (a, _), (b, _) in zip(with_stash, without):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_tile_refuses_another_plan():
    """The launcher recomputes the plan and refuses a call whose plan
    differs (here one more ring stage)."""
    from neddf_tpu_torch.kernels import _build

    dev = _card()
    m, width = 500, 256
    x = torch.randn(m, 60, device=dev, dtype=torch.bfloat16)
    ws = [torch.randn(60, width, device=dev, dtype=torch.bfloat16),
          torch.randn(width, width, device=dev, dtype=torch.bfloat16)]
    bs = [torch.zeros(width, device=dev) for _ in ws]
    out = torch.empty(m, width, device=dev, dtype=torch.bfloat16)
    plan = tdm.tile_fwd_plan(2, 0, width, (60,), (0, 0), m=m,
                             sms=torch.cuda.get_device_properties(dev).multi_processor_count)
    ints = list(plan["ints"])
    lib = _build.library()

    def call(values):
        return lib.neddf_mlp_seg_fwd(1, 1, width, width, m, 1, _build.pointers([x]),
                                     _build.ints([60]), 2, _build.pointers(ws),
                                     _build.pointers(bs), _build.ints([0, 0]), None,
                                     out.data_ptr(), _build.ints(values), None,
                                     _build.stream(dev))

    assert call(ints) == 0
    ints[2] += 1
    assert call(ints) != 0
    torch.cuda.synchronize()
