"""The port's ``viz/`` against the JAX package's: marching tetrahedra,
OBJ/DAE export, vertex normals and the GUI geometry builders equal
bitwise on the same inputs; the GUI classes driven by a stub open3d
backend (``tests/viz/test_gui.py``'s), with the same scene after every
event as the JAX package's GUI."""
import numpy as np
import pytest

from neddf_tpu.viz import geoms as jgeoms
from neddf_tpu.viz import gui as jgui
from neddf_tpu.viz import marching as jmarching
from neddf_tpu.viz import mesh_io as jmesh_io
from neddf_tpu_torch.viz import geoms, gui, marching, mesh_io
from tests.viz.test_gui import _FakeDataset, _make_fake_o3d, _mesh_fn
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)


def _volumes():
    rng = np.random.default_rng(0)
    line = np.linspace(-1.0, 1.0, 21)
    x, y, z = np.meshgrid(line, line, line, indexing="ij")
    sphere = np.sqrt(x**2 + y**2 + z**2)
    noisy = (sphere + 0.05 * rng.normal(size=sphere.shape)).astype(np.float32)
    # corners exactly at the level: crossings at t = 0 / 1, welded by position
    steps = np.round(sphere * 4) / 4
    return {
        "sphere": (sphere, 0.6),
        "noisy_f32": (noisy, 0.5),
        "level_on_corners": (steps, 0.5),
        "anisotropic": (rng.uniform(size=(9, 5, 13)), 0.5),
        "empty": (np.zeros((6, 6, 6)), 0.5),
        "full": (np.ones((6, 6, 6)), 0.5),
        "flat": (np.zeros((1, 6, 6)), 0.5),
    }


@pytest.mark.parametrize("name", list(_volumes()))
def test_marching_tetrahedra_equals_jax_bitwise(name):
    volume, level = _volumes()[name]
    v, t = marching.marching_tetrahedra(volume, level)
    jv, jt = jmarching.marching_tetrahedra(volume, level)
    assert v.dtype == jv.dtype and t.dtype == jt.dtype
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(t, jt)
    if name in ("sphere", "noisy_f32", "level_on_corners"):
        assert t.shape[0] > 100


def test_mesh_export_equals_jax_bytewise(tmp_path):
    volume, level = _volumes()["noisy_f32"]
    v, t = marching.marching_tetrahedra(volume, level)
    v = (v - 10.5) * (2.2 / 21)
    np.testing.assert_array_equal(mesh_io.compute_vertex_normals(v, t),
                                  jmesh_io.compute_vertex_normals(v, t))
    for ext, port, ref in (("obj", mesh_io.export_obj, jmesh_io.export_obj),
                           ("dae", mesh_io.export_dae, jmesh_io.export_dae)):
        port(tmp_path / "port" / f"m.{ext}", v, t)
        ref(tmp_path / "jax" / f"m.{ext}", v, t)
        got = (tmp_path / "port" / f"m.{ext}").read_bytes()
        assert got == (tmp_path / "jax" / f"m.{ext}").read_bytes(), ext
        assert len(got) > 1000


def test_geoms_equal_jax_bitwise():
    rng = np.random.default_rng(1)
    calib = np.array([20.0, 22.0, 8.0, 6.0])
    cam = rng.normal(size=6)
    bgr = rng.uniform(0, 255, size=(12, 16, 3)).astype(np.float32)
    cases = [
        ("coordinate_grid", (3,)),
        ("camera_transform", (cam,)),
        ("bounding_box_lines", (np.array([[-1, 1], [-0.5, 1], [-1, 0.7]]),)),
        ("camera_pyramid", (calib, 16, 12, cam)),
        ("image_panel", (calib, 16, 12, cam, bgr)),
        ("slice_panel", (0.35, bgr.astype(np.uint8))),
        ("visible_range_frustum", (calib, 16, 12, cam, 2.0, 6.0)),
    ]
    for name, args in cases:
        got, want = getattr(geoms, name)(*args), getattr(jgeoms, name)(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want, strict=True):
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)
    ds = _FakeDataset()
    got = geoms.dataset_scene_geoms(ds, show_images=True, show_ranges=True)
    want = jgeoms.dataset_scene_geoms(ds, show_images=True, show_ranges=True)
    for key in ("pyramids", "images", "ranges"):
        for g, w in zip(got[key], want[key], strict=True):
            for a, b in zip(g, w, strict=True):
                np.testing.assert_array_equal(a, b)


class _PortRender:
    """The port's ``render_field_slice`` signature (no params argument)."""

    def render_field_slice(self, slice_t=0.0, render_size=1.1, render_resolution=128):
        img = np.full((render_resolution, render_resolution, 3),
                      int(127 + 100 * slice_t) % 255, np.uint8)
        return {"distance": img, "density": img.copy()}


class _JaxRender:
    def render_field_slice(self, params, slice_t, render_size, render_resolution):
        return _PortRender().render_field_slice(slice_t, render_size, render_resolution)


class _Trainer:
    dataset = _FakeDataset()
    params = {}

    def __init__(self, render):
        self.neural_render = render


def _scene(g):
    return sorted(g.scene.scene.geoms)


def test_fields_gui_full_surface_matches_jax():
    port = gui.FieldsVisualizerGUI(_Trainer(_PortRender()), _mesh_fn, backend=_make_fake_o3d())
    ref = jgui.FieldsVisualizerGUI(_Trainer(_JaxRender()), _mesh_fn, backend=_make_fake_o3d())
    scene = port.scene.scene
    assert {"coordinate_grid", "slice_plane", "meshed_field"} <= set(scene.geoms)
    assert sum(1 for k in scene.geoms if k.endswith("_pyramid")) == 3
    assert not any(k.endswith("_rgb") for k in scene.geoms)
    events = [("_on_show_rgb_image", (True,)), ("_on_show_bounding_box", (True,)),
              ("_on_show_visible_range", (True,)), ("_on_slice_parameter_slider", (0.5,)),
              ("_on_slice_fieldname_selection", ("density", 1)),
              ("_on_visible_range_far_slider", (3.0,)),
              ("_on_visible_range_near_slider", (5.0,)),
              ("_on_meshing_resolution", (128,)), ("_on_meshing", ())]
    assert _scene(port) == _scene(ref)
    for name, args in events:
        getattr(port, name)(*args)
        getattr(ref, name)(*args)
        assert _scene(port) == _scene(ref), name
    assert sum(1 for k in scene.geoms if k.endswith("_rgb")) == 3
    assert "bounding_box" in scene.geoms
    assert sum(1 for k in scene.geoms if k.endswith("_range")) == 3
    assert port.slice_parameter == 0.5 and port.slice_field_name == "density"
    assert port.visible_range[0] <= port.visible_range[1]
    np.testing.assert_array_equal(port.visible_range, ref.visible_range)
    assert port.mesh_vertices.max() == pytest.approx(2.0)


def test_dataset_gui_surface_matches_jax():
    port = gui.DatasetVisualizerGUI(_FakeDataset(), backend=_make_fake_o3d())
    ref = jgui.DatasetVisualizerGUI(_FakeDataset(), backend=_make_fake_o3d())
    scene = port.scene.scene
    assert sum(1 for k in scene.geoms if k.endswith("_pyramid")) == 3
    assert sum(1 for k in scene.geoms if k.endswith("_rgb")) == 3
    for name, arg in (("_on_show_rgb_image", False), ("_on_show_visible_range", True)):
        getattr(port, name)(arg)
        getattr(ref, name)(arg)
        assert _scene(port) == _scene(ref), name
    assert not any(k.endswith("_rgb") for k in scene.geoms)
    assert sum(1 for k in scene.geoms if k.endswith("_range")) == 3


def test_open3d_is_imported_only_on_use():
    import subprocess
    import sys

    code = ("import sys; sys.modules['open3d'] = None\n"
            "import neddf_tpu_torch.viz, neddf_tpu_torch.viz.gui\n"
            "import neddf_tpu_torch.scripts.fields_visualizer\n"
            "import neddf_tpu_torch.scripts.dataset_visualizer\n"
            "from neddf_tpu_torch.viz.gui import FieldsVisualizerGUI\n"
            "try:\n"
            "    FieldsVisualizerGUI(None, None)\n"
            "except ImportError:\n"
            "    print('refused')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "refused"
