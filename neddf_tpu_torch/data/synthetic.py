"""Synthetic NeRF-synthetic-format scene generators (numpy only).

Counterpart of ``neddf_tpu/data/synthetic.py``: the same analytic
ray-traced scenes, cameras and files, written in the directory format
``NeRFSyntheticDataset`` parses (``transforms_{split}.json`` + RGBA PNGs,
blender RUB cameras):

* ``generate_sphere_dataset``: one lambertian sphere, the smallest
  hermetic test scene;
* ``generate_machine_dataset``: a toy excavator of ~20 textured
  primitives on a studded baseplate (occlusion, high-frequency texture,
  hard shadows, thin parts), with lego's cameras (500x500,
  camera_angle_x = 0.6911, a hemisphere at distance 4);
* ``generate_drums_dataset``: the thin-structure counterpart (sub-pixel
  stands, edge-on discs).

The renders' channel order is OpenCV's (BGR[A]), as the JAX package
hands them to ``cv2.imwrite``; ``write_bgra`` swaps them to the PNG's
RGB[A], so a file decodes to the JAX package's pixels.

CLI: python -m neddf_tpu_torch.data.synthetic --scene machine --out data/machine
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np

from neddf_tpu_torch.utils.png import write_png


def write_bgra(path: "str | Path", img: np.ndarray) -> None:
    """Write a BGR[A] uint8 image (OpenCV's order) as an RGB[A] PNG."""
    write_png(path, img[:, :, [2, 1, 0, *range(3, img.shape[2])]])


def _look_at(eye: np.ndarray) -> np.ndarray:
    """4x4 camera-to-world with -z looking at the origin (RUB frame)."""
    forward = -eye / np.linalg.norm(eye)  # camera -z
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(forward, up)) > 0.99:
        up = np.array([0.0, 1.0, 0.0])
    right = np.cross(forward, up)
    right /= np.linalg.norm(right)
    true_up = np.cross(right, forward)
    m = np.eye(4)
    m[:3, 0] = right
    m[:3, 1] = true_up
    m[:3, 2] = -forward  # RUB: +z is backward
    m[:3, 3] = eye
    return m


def _render_sphere(
    c2w: np.ndarray,
    size: int,
    focal: float,
    radius: float,
    color: np.ndarray,
) -> np.ndarray:
    """RGBA uint8 render of a shaded sphere at the origin."""
    ys, xs = np.mgrid[0:size, 0:size]
    # pixel centers -> RUB camera dirs (pinhole, cx=cy=size/2)
    dx = (xs + 0.5 - size / 2) / focal
    dy = -(ys + 0.5 - size / 2) / focal
    dirs = np.stack([dx, dy, -np.ones_like(dx)], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs = dirs @ c2w[:3, :3].T
    orig = c2w[:3, 3]

    # ray-sphere: |o + t d|^2 = r^2
    b = 2.0 * dirs @ orig
    c = float(orig @ orig) - radius * radius
    disc = b * b - 4.0 * c
    hit = disc > 0
    t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0.0))) / 2.0, 0.0)
    hit &= t > 0

    p = orig[None, None, :] + t[..., None] * dirs
    normal = p / max(radius, 1e-8)
    # headlight lambertian
    lam = np.clip(-(normal * dirs).sum(-1), 0.0, 1.0)
    shade = (0.2 + 0.8 * lam)[..., None] * color[None, None, :]

    img = np.zeros((size, size, 4), np.uint8)
    img[..., :3] = np.where(hit[..., None], (shade * 255).astype(np.uint8), 0)
    img[..., 3] = np.where(hit, 255, 0).astype(np.uint8)
    return img


def generate_sphere_dataset(
    out_dir: "str | Path",
    n_train: int = 6,
    n_test: int = 2,
    image_size: int = 64,
    camera_distance: float = 4.0,
    radius: float = 0.6,
    seed: int = 0,
) -> Path:
    """Write a minimal NeRF-synthetic-format scene; returns its path."""
    out_dir = Path(out_dir)
    rng = np.random.default_rng(seed)
    camera_angle_x = 2.0 * np.arctan(0.5 * image_size / (1.2 * image_size))
    focal = 0.5 * image_size / np.tan(0.5 * camera_angle_x)
    color = np.array([0.9, 0.55, 0.25])

    for split, count in (("train", n_train), ("test", n_test)):
        (out_dir / split).mkdir(parents=True, exist_ok=True)
        frames = []
        for i in range(count):
            theta = 2 * np.pi * (i + rng.uniform(0, 0.5)) / max(count, 1)
            phi = np.deg2rad(rng.uniform(20, 60))
            eye = camera_distance * np.array(
                [np.cos(theta) * np.cos(phi), np.sin(theta) * np.cos(phi), np.sin(phi)]
            )
            c2w = _look_at(eye)
            img = _render_sphere(c2w, image_size, focal, radius, color)
            name = f"./{split}/r_{i}"
            write_bgra(out_dir / f"{name}.png", img)
            frames.append(
                {"file_path": name, "transform_matrix": c2w.tolist()}
            )
        with open(out_dir / f"transforms_{split}.json", "w") as f:
            json.dump(
                {"camera_angle_x": float(camera_angle_x), "frames": frames}, f
            )
    return out_dir


# --------------------------------------------------------------------------
# Multi-object textured scene ("machine") — nerf_synthetic validation proxy
# --------------------------------------------------------------------------

_INF = 1e30


class _Prim:
    """Analytic primitive: vectorised intersect -> (t, normal, valid)."""

    def __init__(self, color, texture=None):
        self.color = np.asarray(color, np.float64)
        self.texture = texture  # fn(points [N,3]) -> [N,3] rgb multiplier

    def shade(self, p: np.ndarray) -> np.ndarray:
        c = np.broadcast_to(self.color, p.shape).copy()
        if self.texture is not None:
            c = c * self.texture(p)
        return c


class _Sphere(_Prim):
    def __init__(self, center, radius, color, texture=None):
        super().__init__(color, texture)
        self.c = np.asarray(center, np.float64)
        self.r = float(radius)

    def intersect(self, o: np.ndarray, d: np.ndarray) -> tuple:
        oc = o - self.c
        b = 2.0 * np.sum(d * oc, axis=-1)
        c = np.sum(oc * oc, axis=-1) - self.r * self.r
        disc = b * b - 4.0 * c
        ok = disc > 0
        sq = np.sqrt(np.maximum(disc, 0.0))
        t = np.where(ok, (-b - sq) / 2.0, _INF)
        t = np.where(t > 1e-6, t, np.where(ok, (-b + sq) / 2.0, _INF))
        t = np.where(t > 1e-6, t, _INF)
        n = (o + t[..., None] * d - self.c) / self.r
        return t, n


class _Box(_Prim):
    def __init__(self, lo, hi, color, texture=None):
        super().__init__(color, texture)
        self.lo = np.asarray(lo, np.float64)
        self.hi = np.asarray(hi, np.float64)

    def intersect(self, o: np.ndarray, d: np.ndarray) -> tuple:
        inv = 1.0 / np.where(np.abs(d) < 1e-12, 1e-12, d)
        t0 = (self.lo - o) * inv
        t1 = (self.hi - o) * inv
        tmin = np.max(np.minimum(t0, t1), axis=-1)
        tmax = np.min(np.maximum(t0, t1), axis=-1)
        ok = (tmax > np.maximum(tmin, 1e-6))
        t = np.where(ok & (tmin > 1e-6), tmin, np.where(ok, tmax, _INF))
        p = o + t[..., None] * d
        # face normal from the dominant axis of the local coordinate
        center = 0.5 * (self.lo + self.hi)
        half = 0.5 * (self.hi - self.lo)
        local = (p - center) / np.where(half < 1e-12, 1e-12, half)
        axis = np.argmax(np.abs(local), axis=-1)
        n = np.zeros_like(p)
        idx = np.arange(p.reshape(-1, 3).shape[0])
        nf = n.reshape(-1, 3)
        lf = local.reshape(-1, 3)
        af = axis.reshape(-1)
        nf[idx, af] = np.sign(lf[idx, af])
        return t, n


class _CylinderZ(_Prim):
    """Finite cylinder along an axis-parallel line (axis in {0,1,2})."""

    def __init__(self, center, radius, half_len, axis, color, texture=None):
        super().__init__(color, texture)
        self.c = np.asarray(center, np.float64)
        self.r = float(radius)
        self.h = float(half_len)
        self.axis = int(axis)

    def intersect(self, o: np.ndarray, d: np.ndarray) -> tuple:
        ax = self.axis
        other = [i for i in range(3) if i != ax]
        oc = o - self.c
        dd = d[..., other]
        oo = oc[..., other]
        a = np.sum(dd * dd, axis=-1)
        b = 2.0 * np.sum(dd * oo, axis=-1)
        c = np.sum(oo * oo, axis=-1) - self.r * self.r
        disc = b * b - 4.0 * a * c
        ok = (disc > 0) & (a > 1e-12)
        sq = np.sqrt(np.maximum(disc, 0.0))
        a_safe = np.where(a > 1e-12, a, 1.0)
        t_near = (-b - sq) / (2.0 * a_safe)
        t_far = (-b + sq) / (2.0 * a_safe)

        def side_ok(t):
            z = oc[..., ax] + t * d[..., ax]
            return ok & (t > 1e-6) & (np.abs(z) <= self.h)

        t = np.where(side_ok(t_near), t_near,
                     np.where(side_ok(t_far), t_far, _INF))
        # caps
        for cap in (-self.h, self.h):
            denom = np.where(np.abs(d[..., ax]) < 1e-12, 1e-12, d[..., ax])
            t_cap = (cap - oc[..., ax]) / denom
            pp = oc[..., other] + t_cap[..., None] * dd
            in_cap = (np.sum(pp * pp, axis=-1) <= self.r * self.r) & (
                t_cap > 1e-6
            )
            t = np.where(in_cap & (t_cap < t), t_cap, t)
        p = o + t[..., None] * d
        local = p - self.c
        on_cap = np.abs(np.abs(local[..., ax]) - self.h) < 1e-6
        n = np.zeros_like(p)
        n[..., other] = local[..., other] / self.r
        n_cap = np.zeros_like(p)
        n_cap[..., ax] = np.sign(local[..., ax])
        n = np.where(on_cap[..., None], n_cap, n)
        return t, n


def _checker(scale, a=1.0, b=0.55):
    def tex(p):
        s = np.floor(p[..., 0] * scale) + np.floor(p[..., 1] * scale)
        m = np.where(s % 2 == 0, a, b)
        return m[..., None] * np.ones(3)

    return tex


def _studs(scale):
    """Round lego-stud-like bumps in brightness (pure texture)."""

    def tex(p):
        fx = p[..., 0] * scale - np.floor(p[..., 0] * scale) - 0.5
        fy = p[..., 1] * scale - np.floor(p[..., 1] * scale) - 0.5
        r = np.sqrt(fx * fx + fy * fy)
        m = np.where(r < 0.3, 1.25, 0.95)
        return m[..., None] * np.ones(3)

    return tex


def _stripes(scale, axis=0, a=1.0, b=0.6):
    def tex(p):
        m = np.where(np.floor(p[..., axis] * scale) % 2 == 0, a, b)
        return m[..., None] * np.ones(3)

    return tex


def _machine_scene():
    """Toy excavator on a studded baseplate, in [-1.05, 1.05]^3."""
    yellow = [0.95, 0.75, 0.1]
    dark = [0.15, 0.15, 0.18]
    gray = [0.55, 0.55, 0.6]
    red = [0.85, 0.12, 0.1]
    blue = [0.2, 0.35, 0.8]
    green = [0.3, 0.65, 0.25]
    prims = [
        # studded baseplate
        _Box([-1.0, -1.0, -0.95], [1.0, 1.0, -0.82], green, _studs(8.0)),
        # tracked undercarriage
        _Box([-0.55, -0.42, -0.82], [0.55, -0.26, -0.58], dark, _stripes(14.0, 0)),
        _Box([-0.55, 0.26, -0.82], [0.55, 0.42, -0.58], dark, _stripes(14.0, 0)),
        # drive wheels poking out of the tracks
        _CylinderZ([-0.55, -0.34, -0.70], 0.12, 0.085, 1, gray),
        _CylinderZ([0.55, -0.34, -0.70], 0.12, 0.085, 1, gray),
        _CylinderZ([-0.55, 0.34, -0.70], 0.12, 0.085, 1, gray),
        _CylinderZ([0.55, 0.34, -0.70], 0.12, 0.085, 1, gray),
        # body + checkered deck
        _Box([-0.5, -0.3, -0.58], [0.4, 0.3, -0.28], yellow, _checker(10.0)),
        # cab with dark "window" stripe
        _Box([-0.05, -0.22, -0.28], [0.35, 0.22, 0.12], yellow,
             _stripes(6.0, 2, 1.0, 0.35)),
        # engine block
        _Box([-0.5, -0.2, -0.28], [-0.12, 0.2, -0.1], gray, _stripes(20.0, 1)),
        # boom: three slanted steps toward the front-low blade
        _Box([0.35, -0.07, -0.1], [0.62, 0.07, 0.02], yellow),
        _Box([0.55, -0.06, -0.3], [0.78, 0.06, -0.06], yellow),
        _Box([0.7, -0.05, -0.55], [0.88, 0.05, -0.26], yellow),
        # bucket/blade
        _Box([0.82, -0.3, -0.82], [0.95, 0.3, -0.5], gray, _stripes(16.0, 1)),
        # counterweight sphere + beacon
        _Sphere([-0.58, 0.0, -0.2], 0.14, red),
        _CylinderZ([0.05, 0.0, 0.17], 0.025, 0.1, 2, dark),
        _Sphere([0.05, 0.0, 0.32], 0.055, red),
        # scattered bricks on the plate (occluders + color variety)
        _Box([-0.85, 0.55, -0.82], [-0.55, 0.75, -0.66], blue, _studs(8.0)),
        _Box([0.45, -0.85, -0.82], [0.75, -0.62, -0.7], red, _studs(8.0)),
        _Box([-0.8, -0.75, -0.82], [-0.6, -0.55, -0.58], gray, _studs(8.0)),
    ]
    light = np.array([0.45, 0.25, 0.86])
    return prims, light / np.linalg.norm(light)


def _drums_scene():
    """Drum-kit-like arrangement in [-1.05, 1.05]^3 — the thin-structure
    counterpart of the machine scene (nerf_synthetic *drums* proxy:
    BASELINE.json configs #3/#4 name drums alongside lego). Difficulty
    profile: sub-pixel-width stands (radius 0.022-0.03 at 500 px ≈ 2-3
    px), large flat discs seen edge-on (cymbals), and repeated curved
    shells with high-frequency textures."""
    shell = [0.82, 0.2, 0.16]
    rim = [0.85, 0.85, 0.88]
    brass = [0.9, 0.78, 0.3]
    dark = [0.12, 0.12, 0.14]
    floor_c = [0.45, 0.5, 0.55]
    prims = [
        # checkered floor slab
        _Box([-1.0, -1.0, -0.95], [1.0, 1.0, -0.84], floor_c, _checker(6.0)),
        # kick drum: horizontal cylinder (axis y), striped shell
        _CylinderZ([0.0, 0.0, -0.5], 0.34, 0.26, 1, shell, _stripes(12.0, 2)),
        _CylinderZ([0.0, 0.0, -0.5], 0.07, 0.30, 1, rim),  # hub caps
        # snare + two toms: vertical cylinders with striped shells
        _CylinderZ([-0.62, 0.3, -0.64], 0.2, 0.09, 2, rim, _stripes(16.0, 0)),
        _CylinderZ([-0.2, 0.52, -0.45], 0.17, 0.11, 2, shell,
                   _stripes(14.0, 1)),
        _CylinderZ([0.25, 0.55, -0.42], 0.2, 0.12, 2, shell,
                   _stripes(14.0, 0)),
        # cymbals: thin flat discs at height, studded brass
        _CylinderZ([-0.65, -0.45, -0.1], 0.3, 0.012, 2, brass, _studs(10.0)),
        _CylinderZ([0.68, -0.4, 0.02], 0.34, 0.012, 2, brass, _studs(10.0)),
        _CylinderZ([0.72, 0.42, -0.12], 0.26, 0.012, 2, brass, _studs(10.0)),
        # stands: sub-pixel-width vertical rods under cymbals/snare/toms
        _CylinderZ([-0.65, -0.45, -0.5], 0.026, 0.4, 2, dark),
        _CylinderZ([0.68, -0.4, -0.42], 0.026, 0.44, 2, dark),
        _CylinderZ([0.72, 0.42, -0.5], 0.026, 0.38, 2, dark),
        _CylinderZ([-0.62, 0.3, -0.8], 0.03, 0.08, 2, dark),
        _CylinderZ([-0.2, 0.52, -0.66], 0.022, 0.1, 2, dark),
        _CylinderZ([0.25, 0.55, -0.66], 0.022, 0.12, 2, dark),
        # horizontal support arm + pedal beater sphere
        _CylinderZ([0.0, -0.35, -0.72], 0.022, 0.35, 0, dark),
        _Sphere([0.0, -0.34, -0.5], 0.05, rim),
        # knobs on the kick shell
        _Sphere([0.17, 0.28, -0.36], 0.035, brass),
        _Sphere([-0.17, 0.28, -0.36], 0.035, brass),
    ]
    light = np.array([-0.35, 0.3, 0.88])
    return prims, light / np.linalg.norm(light)


def _trace(prims, o, d):
    """Nearest-hit over all primitives: (t, normal, prim_id)."""
    flat_d = d.reshape(-1, 3)
    flat_o = np.broadcast_to(o, flat_d.shape)
    best_t = np.full(flat_d.shape[0], _INF)
    best_n = np.zeros_like(flat_d)
    best_id = np.full(flat_d.shape[0], -1, np.int64)
    for pid, prim in enumerate(prims):
        t, n = prim.intersect(flat_o, flat_d)
        closer = t < best_t
        best_t = np.where(closer, t, best_t)
        best_n = np.where(closer[..., None], n, best_n)
        best_id = np.where(closer, pid, best_id)
    return best_t, best_n, best_id


def _render_machine(prims, light, c2w, size, focal):
    ys, xs = np.mgrid[0:size, 0:size]
    dx = (xs + 0.5 - size / 2) / focal
    dy = -(ys + 0.5 - size / 2) / focal
    dirs = np.stack([dx, dy, -np.ones_like(dx)], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs = dirs @ c2w[:3, :3].T
    orig = c2w[:3, 3]

    t, n, pid = _trace(prims, orig, dirs)
    hit = pid >= 0
    p = orig[None, :] + t[..., None] * dirs.reshape(-1, 3)

    # per-primitive albedo with texture
    albedo = np.zeros_like(p)
    for i, prim in enumerate(prims):
        m = pid == i
        if np.any(m):
            albedo[m] = prim.shade(p[m])

    lam = np.clip(np.sum(n * light[None, :], axis=-1), 0.0, 1.0)
    # hard shadows: occlusion ray toward the light
    st, _, s_id = _trace(prims, p + 1e-4 * light[None, :],
                         np.broadcast_to(light, p.shape))
    lit = s_id < 0
    shade = 0.3 + 0.7 * lam * lit
    rgb = np.clip(albedo * shade[..., None], 0.0, 1.0)

    img = np.zeros((size * size, 4), np.uint8)
    img[:, :3] = np.where(hit[:, None], (rgb * 255).astype(np.uint8), 0)
    img[:, 3] = np.where(hit, 255, 0).astype(np.uint8)
    return img.reshape(size, size, 4)


def generate_machine_dataset(
    out_dir: "str | Path",
    n_train: int = 100,
    n_test: int = 25,
    image_size: int = 500,
    camera_distance: float = 4.0,
    seed: int = 0,
    _scene_fn: Any = _machine_scene,
) -> Path:
    """Write the multi-object textured validation scene.

    Camera conventions match lego / bunny_smoke: camera_angle_x =
    0.6911112 (focal = 0.5*w/tan(angle/2), the reference's focal rule at
    nerf_synthetic_dataset.py:49-50), upper-hemisphere ring at distance
    4, images 500x500 RGBA.
    """
    out_dir = Path(out_dir)
    rng = np.random.default_rng(seed)
    camera_angle_x = 0.6911112070083618
    focal = 0.5 * image_size / np.tan(0.5 * camera_angle_x)
    prims, light = _scene_fn()

    for split, count in (("train", n_train), ("test", n_test)):
        (out_dir / split).mkdir(parents=True, exist_ok=True)
        frames = []
        for i in range(count):
            theta = 2 * np.pi * (i + rng.uniform(0.0, 0.9)) / max(count, 1)
            phi = np.deg2rad(rng.uniform(25.0, 65.0))
            eye = camera_distance * np.array(
                [np.cos(theta) * np.cos(phi), np.sin(theta) * np.cos(phi),
                 np.sin(phi)]
            )
            c2w = _look_at(eye)
            img = _render_machine(prims, light, c2w, image_size, focal)
            name = f"./{split}/r_{i}"
            write_bgra(out_dir / f"{name}.png", img)
            frames.append({"file_path": name, "transform_matrix": c2w.tolist()})
        with open(out_dir / f"transforms_{split}.json", "w") as f:
            json.dump(
                {"camera_angle_x": float(camera_angle_x), "frames": frames}, f
            )
    return out_dir


def generate_drums_dataset(
    out_dir: "str | Path",
    n_train: int = 100,
    n_test: int = 25,
    image_size: int = 500,
    camera_distance: float = 4.0,
    seed: int = 0,
) -> Path:
    """Write the thin-structure drum-kit validation scene (see
    _drums_scene); same camera conventions as the machine scene."""
    return generate_machine_dataset(
        out_dir, n_train=n_train, n_test=n_test, image_size=image_size,
        camera_distance=camera_distance, seed=seed, _scene_fn=_drums_scene,
    )


def main() -> None:
    from argparse import ArgumentParser

    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--scene", choices=["sphere", "machine", "drums"],
                        default="machine")
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--train", type=int, default=100)
    parser.add_argument("--test", type=int, default=25)
    parser.add_argument("--size", type=int, default=500)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    gen = {
        "machine": generate_machine_dataset,
        "drums": generate_drums_dataset,
        "sphere": generate_sphere_dataset,
    }[args.scene]
    path = gen(args.out, n_train=args.train, n_test=args.test,
               image_size=args.size, seed=args.seed)
    print(f"wrote {args.scene} scene to {path}")


if __name__ == "__main__":
    main()
