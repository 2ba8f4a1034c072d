"""ScanNet 2-view pretraining data, frames -> pairs (port of
ao_tpu/datasets/preprocessing/preprocess_scannet_pair.py; reference:
pointcept/datasets/preprocessing/scannet/scannet_pair/{SensorData,reader,
point_cloud_extractor,compute_full_overlapping,generage_list}.py).

1. parse each scene's ``.sens`` stream (version-4 binary: intrinsics,
   zlib-compressed 16-bit depth, jpeg color, per-frame camera-to-world
   poses) — or consume an already-exported ``intrinsic/ pose/ depth/
   color/`` directory;
2. unproject every ``frame_skip``-th depth frame through the depth
   intrinsics and pose into a world-space colored point cloud
   (``<scene>/pcd/<frame>.npz``);
3. score all frame pairs by overlap: clouds are voxelised at
   ``voxel_size`` and the ratio counts source voxels with an occupied
   27-neighbourhood in the target, the larger of both directions
   (:func:`overlap_ratio`, vectorised over integer voxel keys: the same
   counts as the JAX package's walk over a Python set);
4. write ``<scene>/pcd/overlap.txt`` and a global ``overlap30.txt``
   (pairs with overlap >= 0.3), the files ScanNetPairDataset consumes.

The files equal the JAX package's on the same input (the ``.npz`` arrays
and every ``overlap.txt`` line). Needs numpy and Pillow only.

Usage:
    python -m ao_tpu_torch.datasets.preprocessing.preprocess_scannet_pair \
        --dataset-root <dir with scene*/ (.sens or exported frames)> \
        --output-root out [--frame-skip 25] [--voxel-size 0.05]
"""

from __future__ import annotations

import argparse
import glob
import io
import os
import struct
import zlib

import numpy as np


class SensReader:
    """Minimal .sens (version 4) stream reader."""

    def __init__(self, path):
        self.f = open(path, "rb")
        u32 = lambda: struct.unpack("I", self.f.read(4))[0]
        i32 = lambda: struct.unpack("i", self.f.read(4))[0]
        u64 = lambda: struct.unpack("Q", self.f.read(8))[0]
        f32 = lambda: struct.unpack("f", self.f.read(4))[0]
        mat4 = lambda: np.frombuffer(
            self.f.read(64), np.float32
        ).reshape(4, 4).copy()

        version = u32()
        if version != 4:
            raise ValueError(f"unsupported .sens version {version}")
        name_len = u64()
        self.sensor_name = self.f.read(name_len).decode("ascii", "replace")
        self.intrinsic_color = mat4()
        self.extrinsic_color = mat4()
        self.intrinsic_depth = mat4()
        self.extrinsic_depth = mat4()
        self.color_compression = i32()  # 2 = jpeg
        self.depth_compression = i32()  # 1 = zlib_ushort
        self.color_width, self.color_height = u32(), u32()
        self.depth_width, self.depth_height = u32(), u32()
        self.depth_shift = f32()
        self.num_frames = u64()

    def frames(self):
        """Yields (pose 4x4, depth uint16 (H, W), color uint8 (h, w, 3))."""
        from PIL import Image

        for _ in range(self.num_frames):
            pose = np.frombuffer(self.f.read(64), np.float32).reshape(4, 4)
            self.f.read(16)  # color/depth timestamps
            color_bytes, depth_bytes = struct.unpack("QQ", self.f.read(16))
            color_data = self.f.read(color_bytes)
            depth_data = self.f.read(depth_bytes)
            if self.depth_compression == 1:  # zlib_ushort
                depth = np.frombuffer(
                    zlib.decompress(depth_data), np.uint16
                ).reshape(self.depth_height, self.depth_width)
            else:  # raw_ushort
                depth = np.frombuffer(depth_data, np.uint16).reshape(
                    self.depth_height, self.depth_width
                )
            color = np.array(Image.open(io.BytesIO(color_data)))[..., :3]
            yield pose.copy(), depth.copy(), color


def unproject_depth(depth, intrinsic, pose, depth_shift=1000.0, color=None):
    """Depth map (mm) -> world-space points (+ optional per-point color,
    sampled from the color image resized to the depth grid)."""
    h, w = depth.shape
    fx, fy = intrinsic[0, 0], intrinsic[1, 1]
    cx, cy = intrinsic[0, 2], intrinsic[1, 2]
    bx, by = intrinsic[0, 3], intrinsic[1, 3]
    v, u = np.nonzero(depth)
    z = depth[v, u].astype(np.float64) / depth_shift
    x = (u - cx) * z / fx + bx
    y = (v - cy) * z / fy + by
    cam = np.stack([x, y, z, np.ones_like(z)], axis=1)
    world = cam @ pose.T
    out = dict(coord=world[:, :3].astype(np.float32))
    if color is not None:
        from PIL import Image

        img = np.array(
            Image.fromarray(color).resize((w, h))
        )
        out["color"] = img[v, u].astype(np.float32)
    return out


def overlap_ratio(coord0, coord1, voxel_size=0.05):
    """Fraction of one cloud's occupied voxels whose 27-neighbourhood is
    occupied in the other (the larger direction, like the reference's
    max(overlap01, overlap10))."""
    a = np.unique(np.floor(coord0 / voxel_size).astype(np.int64), axis=0)
    b = np.unique(np.floor(coord1 / voxel_size).astype(np.int64), axis=0)
    if len(a) == 0 or len(b) == 0:
        return 0.0
    # one integer key a voxel, on a box one voxel wider than both clouds
    lo = np.minimum(a.min(0), b.min(0)) - 1
    ext = np.maximum(a.max(0), b.max(0)) + 2 - lo

    def key(v):
        v = v - lo
        return (v[:, 0] * ext[1] + v[:, 1]) * ext[2] + v[:, 2]

    offs = np.array([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                     for k in (-1, 0, 1)])

    def hit_fraction(src, dst):
        dst_keys = np.sort(key(dst))
        hit = np.zeros(len(src), bool)
        for o in offs:
            q = key(src + o)
            pos = np.minimum(np.searchsorted(dst_keys, q), len(dst_keys) - 1)
            hit |= dst_keys[pos] == q
        return int(hit.sum()) / max(len(src), 1)

    return max(hit_fraction(a, b), hit_fraction(b, a))


def process_scene(scene_dir, out_dir, frame_skip=25, voxel_size=0.05,
                  overlap_voxel=0.05):
    """Extract frame clouds + pairwise overlap list for one scene."""
    scene_id = os.path.basename(os.path.normpath(scene_dir))
    pcd_dir = os.path.join(out_dir, scene_id, "pcd")
    os.makedirs(pcd_dir, exist_ok=True)

    sens = glob.glob(os.path.join(scene_dir, "*.sens"))
    clouds = []
    if sens:
        reader = SensReader(sens[0])
        for i, (pose, depth, color) in enumerate(reader.frames()):
            if i % frame_skip != 0 or not np.isfinite(pose).all():
                continue
            pcd = unproject_depth(
                depth, reader.intrinsic_depth, pose,
                reader.depth_shift, color,
            )
            if pcd["coord"].shape[0] == 0:
                continue
            path = os.path.join(pcd_dir, f"{i}.npz")
            np.savez(path, **pcd)
            clouds.append((path, pcd["coord"]))
    else:  # pre-exported intrinsic/ pose/ depth/ color/ layout
        from PIL import Image

        intr = np.loadtxt(
            os.path.join(scene_dir, "intrinsic", "intrinsic_depth.txt")
        )
        frames = sorted(
            glob.glob(os.path.join(scene_dir, "depth", "*.png")),
            key=lambda p: int(os.path.splitext(os.path.basename(p))[0]),
        )
        for dpath in frames[::frame_skip]:
            fid = os.path.splitext(os.path.basename(dpath))[0]
            pose = np.loadtxt(os.path.join(scene_dir, "pose", f"{fid}.txt"))
            if not np.isfinite(pose).all():
                continue
            depth = np.array(Image.open(dpath))
            cpath = os.path.join(scene_dir, "color", f"{fid}.png")
            color = np.array(Image.open(cpath))[..., :3] if os.path.isfile(
                cpath
            ) else None
            pcd = unproject_depth(depth, intr, pose, 1000.0, color)
            if pcd["coord"].shape[0] == 0:
                continue
            path = os.path.join(pcd_dir, f"{fid}.npz")
            np.savez(path, **pcd)
            clouds.append((path, pcd["coord"]))

    with open(os.path.join(pcd_dir, "overlap.txt"), "w") as f:
        for i in range(len(clouds)):
            for j in range(i + 1, len(clouds)):
                ratio = overlap_ratio(
                    clouds[i][1], clouds[j][1], overlap_voxel
                )
                f.write(f"{clouds[i][0]} {clouds[j][0]} {ratio:.4f}\n")
    return len(clouds)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset-root", required=True,
                    help="directory of scene folders (.sens or exported)")
    ap.add_argument("--output-root", required=True)
    ap.add_argument("--frame-skip", type=int, default=25)
    ap.add_argument("--voxel-size", type=float, default=0.05)
    ap.add_argument("--overlap-threshold", type=float, default=0.3)
    args = ap.parse_args(argv)

    scenes = sorted(
        p for p in glob.glob(os.path.join(args.dataset_root, "scene*"))
        if os.path.isdir(p)
    )
    for scene in scenes:
        n = process_scene(
            scene, args.output_root, args.frame_skip, args.voxel_size,
        )
        print(f"{os.path.basename(scene)}: {n} frame clouds")

    # global filtered pair list (reference generage_list.py)
    with open(os.path.join(args.output_root, "overlap30.txt"), "w") as out:
        for overlap in glob.glob(
            os.path.join(args.output_root, "*", "pcd", "overlap.txt")
        ):
            for line in open(overlap):
                p0, p1, r = line.strip().split()
                if float(r) >= args.overlap_threshold:
                    out.write(f"{p0} {p1} {r}\n")
    print("wrote overlap30.txt")


if __name__ == "__main__":
    main()
