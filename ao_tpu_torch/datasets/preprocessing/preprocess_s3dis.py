"""S3DIS raw -> scene files (port of
ao_tpu/datasets/preprocessing/preprocess_s3dis.py; reference:
pointcept/datasets/preprocessing/s3dis/preprocess_s3dis.py:36-248).

Assembles each room of ``<dataset-root>/Area_*/<room>/Annotations/
<class>_<k>.txt`` (x y z r g b a line) into {coord, color, semantic_gt,
instance_gt} (one instance a file, in the files' sorted order; an unknown
class is clutter), written as ``<output-root>/<area>/<room>.npz``, the
layout S3DISDataset reads. Normals are added only where open3d imports,
as in the JAX package. A room whose file exists is skipped.

Usage:
    python -m ao_tpu_torch.datasets.preprocessing.preprocess_s3dis \
        --dataset-root <Stanford3dDataset_v1.2_Aligned_Version> \
        --output-root out [--num-workers 8]
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from ._pool import pool_map

CLASS_NAMES = (
    "ceiling", "floor", "wall", "beam", "column", "window", "door", "table",
    "chair", "sofa", "bookcase", "board", "clutter",
)
CLASS2ID = {n: i for i, n in enumerate(CLASS_NAMES)}


def parse_room(room_dir: str, out_dir: str, align_angle: bool = False):
    """Writes one room's .npz; returns its path, or None for a room with no
    annotation file."""
    room_name = os.path.basename(room_dir.rstrip("/"))
    area_name = os.path.basename(os.path.dirname(room_dir.rstrip("/")))
    out_path = os.path.join(out_dir, area_name, f"{room_name}.npz")
    if os.path.isfile(out_path):
        return out_path
    coords, colors, semantics, instances = [], [], [], []
    ann_files = sorted(glob.glob(os.path.join(room_dir, "Annotations", "*.txt")))
    for inst_id, ann in enumerate(ann_files):
        cid = CLASS2ID.get(os.path.basename(ann).split("_")[0],
                           CLASS2ID["clutter"])
        data = np.loadtxt(ann)
        if data.ndim == 1:
            data = data[None]
        coords.append(data[:, :3].astype(np.float32))
        colors.append(data[:, 3:6].astype(np.float32))
        semantics.append(np.full(len(data), cid, np.int64))
        instances.append(np.full(len(data), inst_id, np.int64))
    if not coords:
        return None
    coord = np.concatenate(coords)
    save = dict(coord=coord, color=np.concatenate(colors),
                semantic_gt=np.concatenate(semantics),
                instance_gt=np.concatenate(instances))
    try:  # normals need a mesh library, optional as in the reference
        import open3d as o3d

        pcd = o3d.geometry.PointCloud()
        pcd.points = o3d.utility.Vector3dVector(coord.astype(np.float64))
        pcd.estimate_normals(search_param=o3d.geometry.KDTreeSearchParamHybrid(
            radius=0.1, max_nn=30))
        save["normal"] = np.asarray(pcd.normals, np.float32)
    except ImportError:
        pass
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    np.savez_compressed(out_path, **save)
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset-root", required=True,
                   help="Stanford3dDataset_v1.2_Aligned_Version root")
    p.add_argument("--output-root", required=True)
    p.add_argument("--num-workers", type=int, default=8)
    args = p.parse_args(argv)
    rooms = sorted(glob.glob(os.path.join(args.dataset_root, "Area_*", "*")))
    rooms = [r for r in rooms if os.path.isdir(os.path.join(r, "Annotations"))]
    for out in pool_map(parse_room, rooms, args.num_workers, args.output_root):
        if out:
            print(out)


if __name__ == "__main__":
    main()
