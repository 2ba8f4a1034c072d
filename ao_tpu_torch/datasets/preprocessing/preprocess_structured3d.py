"""Structured3D -> scene files (port of
ao_tpu/datasets/preprocessing/preprocess_structured3d.py; reference:
pointcept/datasets/preprocessing/structured3d/
preprocess_structured3d.py:1-417): each room's rendered views are
unprojected into a fused world-space point cloud with per-point colors,
cross-product normals and the 25-class semantic labels, then written as
one ``room_<id>.npz`` under ``<out>/<split>/scene_<id>/``.

* perspective views: pixel grid -> inverse pinhole intrinsics (built
  from the camera file's fov half-angles) x depth -> camera frame ->
  world frame via the camera rotation/translation.
* panorama views: equirectangular spherical unprojection.
* filtering: zero/invalid depth, unlabeled pixels, grazing surfaces
  (|cos(view, normal)| <= 0.15).
* splits by scene id: <3000 train, 3000-3249 val, >=3250 test.

Usage:
    python -m ao_tpu_torch.datasets.preprocessing.preprocess_structured3d \
        --dataset-root <dir with Structured3D *.zip> --output-root out \
        [--grid-size 0.02] [--no-prsp | --no-pano]
"""

from __future__ import annotations

import argparse
import io
import os
import zipfile

import numpy as np

# NYU40 ids retained by the 25-class benchmark, in label order
# (reference preprocess_structured3d.py:23-75)
VALID_CLASS_IDS_25 = (
    1, 2, 3, 4, 5, 6, 7, 8, 9, 11, 14, 15, 16, 17, 18, 19, 22, 24, 25,
    32, 34, 35, 38, 39, 40,
)
CLASS_LABELS_25 = (
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "picture", "desk", "shelves", "curtain", "dresser", "pillow",
    "mirror", "ceiling", "refrigerator", "television", "nightstand",
    "sink", "lamp", "otherstructure", "otherfurniture", "otherprop",
)

# Structured3D camera files are y-up; the benchmark cloud is z-up
_Z2Y = np.array([[0, 1, 0], [0, 0, 1], [1, 0, 0]], np.float32)
_CAM2WORLD = np.array([[0, 0, 1], [0, -1, 0], [1, 0, 0]], np.float32)
_SWAP_YZ = np.array([[1, 0, 0], [0, 0, 1], [0, 1, 0]], np.float32)


class ZipTree:
    """Uniform view over the dataset's (possibly several) zip shards."""

    def __init__(self, zip_paths):
        self._zips = [zipfile.ZipFile(p) for p in zip_paths]
        self._owner = {}
        for z in self._zips:
            for name in z.namelist():
                self._owner[name] = z

    def listdir(self, prefix):
        prefix = prefix.rstrip("/") + "/"
        children = {
            n[len(prefix):].split("/")[0]
            for n in self._owner
            if n.startswith(prefix) and n != prefix
        }
        children.discard("")
        return sorted(children)

    def read_bytes(self, name):
        return self._owner[name].read(name)

    def exists(self, name):
        return name in self._owner

    def read_image(self, name):
        from PIL import Image

        return np.array(Image.open(io.BytesIO(self.read_bytes(name))))


def read_camera(tree, path):
    """Returns (rotation cam->world, translation (m), fov half-angles or
    None). The file is 'x y z [front up fov_x fov_y]' in mm / y-up axes
    (reference read_camera, :124-138)."""
    raw = np.fromstring(tree.read_bytes(path), dtype=np.float32, sep=" ")
    t = _Z2Y @ (raw[:3] / 1000.0)
    if raw.shape[0] <= 3:
        return np.eye(3, np.float32), t, None
    front, up = raw[3:6], raw[6:9]
    right = np.cross(front, up)
    rot = _Z2Y @ np.stack([front, up, right], axis=1).astype(np.float32)
    return rot, t, raw[9:11]


def grid_normals(points):
    """Per-pixel normals from the cross product of the image-grid
    derivatives of an (H, W, 3) point map."""
    padded = np.pad(points, ((0, 1), (0, 1), (0, 0)), mode="symmetric")
    dv = padded[:-1, :-1] - padded[1:, :-1]   # along image rows
    dh = padded[:-1, :-1] - padded[:-1, 1:]   # along image cols
    n = np.cross(dv, dh)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    return np.divide(n, norm, out=np.zeros_like(n), where=norm != 0)


def _grazing_mask(coord, normal):
    view = np.maximum(np.linalg.norm(coord, axis=-1), 1e-4)
    cos = np.abs(np.sum(coord * normal, axis=-1) / view)
    return cos > 0.15


def unproject_perspective(depth_mm, fov, cam_r, cam_t):
    """(H, W) mm depth + fov half-angles -> world coords + normals +
    validity (before color/label filtering)."""
    h, w = depth_mm.shape
    fx = (w / 2) / np.tan(fov[0])
    fy = (h / 2) / np.tan(fov[1])
    u = (np.arange(w, dtype=np.float32) - w / 2)[None, :] / fx
    v = (np.arange(h, dtype=np.float32) - h / 2)[:, None] / fy
    z = depth_mm.astype(np.float32)
    cam = np.stack(
        [np.broadcast_to(u, (h, w)) * z, np.broadcast_to(v, (h, w)) * z, z],
        axis=-1,
    )
    cam = cam @ _CAM2WORLD  # camera axes -> reader frame (mm)
    ok = _grazing_mask(cam, grid_normals(cam)) & (depth_mm > 0) \
        & (depth_mm < 65535)
    world = (cam / 1000.0) @ cam_r.T + cam_t
    normal = grid_normals(world)
    return world, normal, ok


def unproject_panorama(depth_mm, cam_t):
    h, w = depth_mm.shape
    lon = (np.arange(w, dtype=np.float32) / w * 2 - 1) * np.pi  # [-pi, pi)
    lat = np.pi / 2 - np.arange(h, dtype=np.float32) / h * np.pi
    lon = np.broadcast_to(lon[None, :], (h, w))
    lat = np.broadcast_to(lat[:, None], (h, w))
    z = depth_mm.astype(np.float32) / 1000.0
    cam = np.stack(
        [np.cos(lon) * np.cos(lat) * z, np.sin(lat) * z,
         np.sin(lon) * np.cos(lat) * z],
        axis=-1,
    )
    ok = _grazing_mask(cam, grid_normals(cam)) & (depth_mm > 0) \
        & (depth_mm < 65535)
    world = cam + cam_t
    return world, grid_normals(world), ok


def map_labels_25(nyu40, ignore_index=-1):
    lut = np.full(256, ignore_index, np.int16)
    for i, v in enumerate(VALID_CLASS_IDS_25):
        lut[v] = i
    return lut[np.clip(nyu40, 0, 255)]


def scene_split(scene_name):
    sid = int(scene_name.split("_")[-1])
    return "train" if sid < 3000 else ("val" if sid < 3250 else "test")


def convert_room(tree, scene, room, ignore_index=-1, grid_size=None,
                 fuse_prsp=True, fuse_pano=True):
    """Fuse one room's views; returns the scene dict or None."""
    room_path = f"Structured3D/{scene}/2D_rendering/{room}"
    chunks = []

    def add_view(world, normal, ok, color, nyu40):
        ok = ok & (nyu40 > 0)
        if not ok.any():
            return
        chunks.append((
            world[ok].reshape(-1, 3),
            color[ok].reshape(-1, 3)[:, :3],
            normal[ok].reshape(-1, 3),
            nyu40[ok].reshape(-1),
        ))

    if fuse_prsp:
        prsp = f"{room_path}/perspective/full"
        for frame in tree.listdir(prsp):
            base = f"{prsp}/{frame}"
            try:
                cam_r, cam_t, fov = read_camera(tree, f"{base}/camera_pose.txt")
                depth = tree.read_image(f"{base}/depth.png").squeeze()
                color = tree.read_image(f"{base}/rgb_rawlight.png")
                seg = tree.read_image(f"{base}/semantic.png").squeeze()
            except Exception as e:  # corrupt frames exist in the dataset
                print(f"skip {scene}/{room}/{frame}: {e}")
                continue
            world, normal, ok = unproject_perspective(depth, fov, cam_r, cam_t)
            add_view(world, normal, ok, color, seg)

    if fuse_pano:
        pano = f"{room_path}/panorama"
        try:
            _, cam_t, _ = read_camera(tree, f"{pano}/camera_xyz.txt")
            depth = tree.read_image(f"{pano}/full/depth.png").squeeze()
            color = tree.read_image(f"{pano}/full/rgb_rawlight.png")
            seg = tree.read_image(f"{pano}/full/semantic.png").squeeze()
        except Exception as e:
            print(f"skip {scene}/{room} panorama: {e}")
        else:
            world, normal, ok = unproject_panorama(depth, cam_t)
            add_view(world, normal, ok, color, seg)

    if not chunks:
        return None
    coord = np.concatenate([c[0] for c in chunks]) @ _SWAP_YZ
    color = np.concatenate([c[1] for c in chunks])
    normal = np.concatenate([c[2] for c in chunks]) @ _SWAP_YZ
    seg = map_labels_25(np.concatenate([c[3] for c in chunks]), ignore_index)

    data = dict(
        coord=coord.astype(np.float32),
        color=color.astype(np.float32),
        normal=normal.astype(np.float32),
        semantic_gt=seg.astype(np.int16),
    )
    if grid_size is not None:
        from ..transform import GridSample

        data = GridSample(
            grid_size=grid_size,
            keys=("coord", "color", "normal", "semantic_gt"),
        )(data)
    return data


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset-root", required=True,
                    help="directory holding the Structured3D *.zip shards")
    ap.add_argument("--output-root", required=True)
    ap.add_argument("--grid-size", type=float, default=None)
    ap.add_argument("--ignore-index", type=int, default=-1)
    ap.add_argument("--no-prsp", action="store_true")
    ap.add_argument("--no-pano", action="store_true")
    args = ap.parse_args(argv)

    zips = [
        os.path.join(args.dataset_root, f)
        for f in sorted(os.listdir(args.dataset_root))
        if f.endswith(".zip")
    ]
    tree = ZipTree(zips)
    for scene in tree.listdir("Structured3D"):
        split = scene_split(scene)
        out_dir = os.path.join(args.output_root, split, scene)
        for room in tree.listdir(f"Structured3D/{scene}/2D_rendering"):
            data = convert_room(
                tree, scene, room, args.ignore_index, args.grid_size,
                fuse_prsp=not args.no_prsp, fuse_pano=not args.no_pano,
            )
            if data is None:
                print(f"skip {scene}/{room}: no valid points")
                continue
            os.makedirs(out_dir, exist_ok=True)
            np.savez(os.path.join(out_dir, f"room_{room}.npz"), **data)
            print(f"{split}/{scene}/room_{room}: {data['coord'].shape[0]} pts")


if __name__ == "__main__":
    main()
