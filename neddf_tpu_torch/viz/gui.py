"""Interactive Open3D GUIs of the two visualizers.

Counterpart of ``neddf_tpu/viz/gui.py`` on the pure-numpy builders of
``viz/geoms.py``:

* a movable z-plane field slice, re-rendered when its slider moves, and a
  field selector filled from the network's outputs;
* camera frusta and the dataset's images as textured planes;
* bounding-box and visible-range toggles with near/far sliders;
* a re-meshing panel (resolution, threshold, a button).

open3d is imported only inside ``_import_open3d``; every class takes a
``backend`` (the open3d module or a stub, as the tests pass), so the
widget and event surface runs without a display. The field slices come
from the port's ``NeRFRender.render_field_slice``."""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from neddf_tpu_torch.viz.geoms import (
    bounding_box_lines,
    camera_pyramid,
    coordinate_grid,
    image_panel,
    slice_panel,
    visible_range_frustum,
)


def _import_open3d():
    import open3d as o3d  # noqa: PLC0415

    return o3d


class FieldsVisualizerGUI:
    """Reference FieldsVisualizer parity (fields_visualizer.py:19-260).

    Args:
        trainer: loaded trainer (params + renderer + dataset).
        mesh_fn: callable (resolution, threshold) -> (vertices, faces)
            regenerating the iso-surface (scripts.fields_visualizer.
            generate_mesh partial).
        backend: open3d module (or a test stub); default imports open3d.
    """

    SLICE_RESOLUTION = 128

    def __init__(self, trainer, mesh_fn, backend: Optional[Any] = None) -> None:
        self.o3d = backend if backend is not None else _import_open3d()
        self.trainer = trainer
        self.mesh_fn = mesh_fn

        # reference state block (:21-40)
        self.show_rgb_image = False
        self.show_bounding_box = False
        self.show_visible_range = False
        self.bounding_box_range = np.array(
            [[-1.0, 1.0], [-1.0, 1.0], [-1.0, 1.0]]
        )
        self.visible_range = np.array([4.0, 6.0])
        self.slice_parameter = 0.0
        self.slice_field_name = "distance"
        self.meshing_resolution = 64
        self.meshing_threshold = 0.0275
        self.mesh_vertices, self.mesh_triangles = mesh_fn(
            self.meshing_resolution, self.meshing_threshold
        )

        gui = self.o3d.visualization.gui
        rendering = self.o3d.visualization.rendering
        self._gui, self._rendering = gui, rendering
        app = gui.Application.instance
        self.window = app.create_window("neddf_tpu Fields Visualizer", 1280, 768)
        self.scene = gui.SceneWidget()
        self.scene.scene = rendering.Open3DScene(self.window.renderer)
        self.scene.scene.set_background([1, 1, 1, 1])

        em = self.window.theme.font_size
        self.settings_panel = gui.Vert(
            0, gui.Margins(0.25 * em, 0.25 * em, 0.25 * em, 0.25 * em)
        )
        self._build_panel(gui, em)
        self.window.set_on_layout(self._on_layout)
        self.window.add_child(self.scene)
        self.window.add_child(self.settings_panel)
        self.refresh_render()

    # ---------------------------------------------------------- widgets
    def _slice_field_names(self):
        """Populate the combo from the network's ACTUAL outputs (the
        reference hardcodes NeDDF's; this works for NeRF/NeuS too)."""
        images = self._render_slices()
        return sorted(images.keys())

    def _build_panel(self, gui, em: float) -> None:
        show = gui.CollapsableVert("Visible options", 0, gui.Margins(em, 0, 0, 0))
        show.set_is_open(True)
        cb_rgb = gui.Checkbox("show rgb images")
        cb_rgb.checked = self.show_rgb_image
        cb_rgb.set_on_checked(self._on_show_rgb_image)
        cb_bb = gui.Checkbox("show bounding box")
        cb_bb.checked = self.show_bounding_box
        cb_bb.set_on_checked(self._on_show_bounding_box)
        cb_vr = gui.Checkbox("show visible range")
        cb_vr.checked = self.show_visible_range
        cb_vr.set_on_checked(self._on_show_visible_range)
        for cb in (cb_rgb, cb_bb, cb_vr):
            show.add_child(cb)

        sl = gui.CollapsableVert("Field Slice parameters", 0, gui.Margins(em, 0, 0, 0))
        sl.set_is_open(True)
        combo = gui.Combobox()
        for name in self._slice_field_names():
            combo.add_item(name)
        combo.set_on_selection_changed(self._on_slice_fieldname_selection)
        slider = gui.Slider(gui.Slider.DOUBLE)
        slider.set_limits(-1.0, 1.0)
        slider.double_value = self.slice_parameter
        slider.set_on_value_changed(self._on_slice_parameter_slider)
        sl.add_child(gui.Label("Slice field name"))
        sl.add_child(combo)
        sl.add_child(gui.Label("Slice Z"))
        sl.add_child(slider)

        vr = gui.CollapsableVert("Camera Visible Ranges", 0, gui.Margins(em, 0, 0, 0))
        vr.set_is_open(False)
        near_s = gui.Slider(gui.Slider.DOUBLE)
        near_s.set_limits(1.0, 8.0)
        near_s.double_value = self.visible_range[0]
        near_s.set_on_value_changed(self._on_visible_range_near_slider)
        far_s = gui.Slider(gui.Slider.DOUBLE)
        far_s.set_limits(1.0, 8.0)
        far_s.double_value = self.visible_range[1]
        far_s.set_on_value_changed(self._on_visible_range_far_slider)
        vr.add_child(gui.Label("Camera Visible area"))
        vr.add_child(near_s)
        vr.add_child(far_s)

        mesh = gui.CollapsableVert("Meshing options", 0, gui.Margins(em, 0, 0, 0))
        mesh.set_is_open(True)
        res = gui.NumberEdit(gui.NumberEdit.Type.INT)
        res.set_value(self.meshing_resolution)
        res.set_limits(8, 256)
        res.set_on_value_changed(self._on_meshing_resolution)
        thr = gui.NumberEdit(gui.NumberEdit.Type.DOUBLE)
        thr.set_value(self.meshing_threshold)
        thr.set_limits(0.001, 50.0)
        thr.set_on_value_changed(self._on_meshing_threshold)
        btn = gui.Button("Generate mesh model")
        btn.set_on_clicked(self._on_meshing)
        mesh.add_child(gui.Label("Marching cube resolution"))
        mesh.add_child(res)
        mesh.add_child(gui.Label("Marching cube threshold"))
        mesh.add_child(thr)
        mesh.add_child(btn)

        sep = int(round(0.5 * em))
        for layout in (show, sl, vr, mesh):
            self.settings_panel.add_fixed(sep)
            self.settings_panel.add_child(layout)

    # --------------------------------------------------------- callbacks
    def _on_show_rgb_image(self, show: bool) -> None:
        self.show_rgb_image = show
        self.refresh_render()

    def _on_show_bounding_box(self, show: bool) -> None:
        self.show_bounding_box = show
        self.refresh_render()

    def _on_show_visible_range(self, show: bool) -> None:
        self.show_visible_range = show
        self.refresh_render()

    def _on_slice_fieldname_selection(self, field_name: str, idx: int) -> None:
        self.slice_field_name = field_name
        self.refresh_render()

    def _on_slice_parameter_slider(self, new_val: float) -> None:
        self.slice_parameter = float(new_val)
        self.refresh_render()

    def _on_visible_range_near_slider(self, new_val: float) -> None:
        self.visible_range[0] = min(float(new_val), self.visible_range[1])

    def _on_visible_range_far_slider(self, new_val: float) -> None:
        self.visible_range[1] = max(float(new_val), self.visible_range[0])

    def _on_meshing_resolution(self, new_val: float) -> None:
        self.meshing_resolution = int(new_val)

    def _on_meshing_threshold(self, new_val: float) -> None:
        self.meshing_threshold = float(new_val)

    def _on_meshing(self) -> None:
        self.mesh_vertices, self.mesh_triangles = self.mesh_fn(
            self.meshing_resolution, self.meshing_threshold
        )
        self.refresh_render()

    def _on_layout(self, layout_context) -> None:
        r = self.window.content_rect
        self.scene.frame = r
        width = 14 * layout_context.theme.font_size
        self._gui_rect = (r, width)

    # ----------------------------------------------------------- drawing
    def _render_slices(self) -> Dict[str, np.ndarray]:
        return self.trainer.neural_render.render_field_slice(
            slice_t=float(self.slice_parameter),
            render_size=1.1,
            render_resolution=self.SLICE_RESOLUTION,
        )

    def _add_lines(self, name, vtx, edges, colors, width=3) -> None:
        o3d = self.o3d
        lines = o3d.geometry.LineSet()
        lines.points = o3d.utility.Vector3dVector(vtx)
        lines.lines = o3d.utility.Vector2iVector(edges)
        lines.colors = o3d.utility.Vector3dVector(colors)
        mat = self._rendering.MaterialRecord()
        mat.shader = "unlitLine"
        mat.line_width = width
        self.scene.scene.add_geometry(name, lines, mat)

    def _add_panel(self, name, vtx, faces, uvs, rgb) -> None:
        o3d = self.o3d
        panel = o3d.geometry.TriangleMesh(
            o3d.utility.Vector3dVector(vtx), o3d.utility.Vector3iVector(faces)
        )
        panel.compute_vertex_normals()
        panel.triangle_uvs = o3d.utility.Vector2dVector(uvs)
        panel.triangle_material_ids = o3d.utility.IntVector([0] * len(faces))
        mat = self._rendering.MaterialRecord()
        mat.shader = "defaultUnlit"
        mat.albedo_img = o3d.geometry.Image(rgb)
        self.scene.scene.add_geometry(name, panel, mat)

    def refresh_render(self) -> None:
        self.scene.scene.clear_geometry()
        self._add_lines("coordinate_grid", *coordinate_grid())

        ds = self.trainer.dataset
        w, h = ds.image_width, ds.image_height
        for idx in range(len(ds)):
            data = ds[idx]
            self._add_lines(
                f"camera_{idx}_pyramid",
                *camera_pyramid(
                    data["camera_calib_params"], w, h, data["camera_params"]
                ),
                width=1,
            )
            if self.show_rgb_image:
                self._add_panel(
                    f"camera_{idx}_rgb",
                    *image_panel(
                        data["camera_calib_params"], w, h,
                        data["camera_params"], data["rgb_images"],
                    ),
                )
            if self.show_visible_range:
                self._add_lines(
                    f"camera_{idx}_range",
                    *visible_range_frustum(
                        data["camera_calib_params"], w, h,
                        data["camera_params"],
                        float(self.visible_range[0]),
                        float(self.visible_range[1]),
                    ),
                    width=1,
                )

        # live slice plane
        images = self._render_slices()
        name = self.slice_field_name
        if name not in images:
            name = next(iter(sorted(images)))
        self._add_panel(
            "slice_plane", *slice_panel(self.slice_parameter, images[name])
        )

        # transparent iso-surface
        o3d = self.o3d
        mesh = o3d.geometry.TriangleMesh(
            o3d.utility.Vector3dVector(self.mesh_vertices),
            o3d.utility.Vector3iVector(self.mesh_triangles),
        )
        mesh.compute_vertex_normals()
        mat = self._rendering.MaterialRecord()
        mat.shader = "defaultLitTransparency"
        mat.base_color = [0.467, 0.467, 0.467, 0.7]
        self.scene.scene.add_geometry("meshed_field", mesh, mat)

        if self.show_bounding_box:
            self._add_lines(
                "bounding_box", *bounding_box_lines(self.bounding_box_range)
            )


class DatasetVisualizerGUI:
    """Reference dataset_visualizer parity: camera pyramids + image
    planes + visible-range boxes over the raw dataset (no model)."""

    def __init__(self, dataset, backend: Optional[Any] = None) -> None:
        self.o3d = backend if backend is not None else _import_open3d()
        self.dataset = dataset
        self.show_rgb_image = True
        self.show_visible_range = False
        self.visible_range = np.array([4.0, 6.0])

        gui = self.o3d.visualization.gui
        rendering = self.o3d.visualization.rendering
        self._gui, self._rendering = gui, rendering
        self.window = gui.Application.instance.create_window(
            "neddf_tpu Dataset Visualizer", 1280, 768
        )
        self.scene = gui.SceneWidget()
        self.scene.scene = rendering.Open3DScene(self.window.renderer)
        self.scene.scene.set_background([1, 1, 1, 1])
        em = self.window.theme.font_size
        self.settings_panel = gui.Vert(
            0, gui.Margins(0.25 * em, 0.25 * em, 0.25 * em, 0.25 * em)
        )
        cb_rgb = gui.Checkbox("show rgb images")
        cb_rgb.checked = True
        cb_rgb.set_on_checked(self._on_show_rgb_image)
        cb_vr = gui.Checkbox("show visible range")
        cb_vr.checked = False
        cb_vr.set_on_checked(self._on_show_visible_range)
        self.settings_panel.add_child(cb_rgb)
        self.settings_panel.add_child(cb_vr)
        self.window.add_child(self.scene)
        self.window.add_child(self.settings_panel)
        self.refresh_render()

    def _on_show_rgb_image(self, show: bool) -> None:
        self.show_rgb_image = show
        self.refresh_render()

    def _on_show_visible_range(self, show: bool) -> None:
        self.show_visible_range = show
        self.refresh_render()

    def refresh_render(self) -> None:
        o3d = self.o3d
        self.scene.scene.clear_geometry()
        ds = self.dataset
        w, h = ds.image_width, ds.image_height
        for idx in range(len(ds)):
            data = ds[idx]
            vtx, edges, colors = camera_pyramid(
                data["camera_calib_params"], w, h, data["camera_params"]
            )
            lines = o3d.geometry.LineSet()
            lines.points = o3d.utility.Vector3dVector(vtx)
            lines.lines = o3d.utility.Vector2iVector(edges)
            lines.colors = o3d.utility.Vector3dVector(colors)
            mat = self._rendering.MaterialRecord()
            mat.shader = "unlitLine"
            mat.line_width = 1
            self.scene.scene.add_geometry(f"camera_{idx}_pyramid", lines, mat)
            if self.show_rgb_image:
                pv, pf, uv, rgb = image_panel(
                    data["camera_calib_params"], w, h, data["camera_params"],
                    data["rgb_images"],
                )
                panel = o3d.geometry.TriangleMesh(
                    o3d.utility.Vector3dVector(pv), o3d.utility.Vector3iVector(pf)
                )
                panel.compute_vertex_normals()
                panel.triangle_uvs = o3d.utility.Vector2dVector(uv)
                panel.triangle_material_ids = o3d.utility.IntVector([0] * len(pf))
                pmat = self._rendering.MaterialRecord()
                pmat.shader = "defaultUnlit"
                pmat.albedo_img = o3d.geometry.Image(rgb)
                self.scene.scene.add_geometry(f"camera_{idx}_rgb", panel, pmat)
            if self.show_visible_range:
                rv, re_, rc = visible_range_frustum(
                    data["camera_calib_params"], w, h, data["camera_params"],
                    float(self.visible_range[0]), float(self.visible_range[1]),
                )
                rl = o3d.geometry.LineSet()
                rl.points = o3d.utility.Vector3dVector(rv)
                rl.lines = o3d.utility.Vector2iVector(re_)
                rl.colors = o3d.utility.Vector3dVector(rc)
                rmat = self._rendering.MaterialRecord()
                rmat.shader = "unlitLine"
                rmat.line_width = 1
                self.scene.scene.add_geometry(f"camera_{idx}_range", rl, rmat)


def run_app(make_gui: Any) -> None:  # pragma: no cover - needs a display
    """Initialize the open3d GUI app, build via ``make_gui()``, run."""
    o3d = _import_open3d()
    app = o3d.visualization.gui.Application.instance
    app.initialize()
    make_gui()
    app.run()
