"""ARKitScenes 3DOD mesh -> scene files (port of
ao_tpu/datasets/preprocessing/preprocess_arkitscenes.py; reference:
pointcept/datasets/preprocessing/arkitscenes/
preprocess_arkitscenes_mesh.py:20-86).

Reads each ``3dod/<split>/<id>/*_mesh.ply``, keeps its vertex positions
and colours, derives vertex normals as the normalised area-weighted sum
of the incident faces' normals, and writes
``<output-root>/<split>/<id>.npz``.

Usage:
    python -m ao_tpu_torch.datasets.preprocessing.preprocess_arkitscenes \
        --dataset-root <ARKitScenes root with 3dod/> --output-root out
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from ...utils.ply import read_ply


def vertex_normals(coord: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals of a triangle mesh."""
    e1 = coord[faces[:, 1]] - coord[faces[:, 0]]
    e2 = coord[faces[:, 2]] - coord[faces[:, 0]]
    fn = np.cross(e1, e2) * 0.5  # its length is the face's area
    nv = np.zeros_like(coord)
    for c in range(3):
        np.add.at(nv, faces[:, c], fn)
    nv /= np.linalg.norm(nv, axis=1, keepdims=True) + 1e-8
    return nv


def convert_mesh(mesh_path: str) -> dict:
    vertex, faces = read_ply(mesh_path, triangular_mesh=True)
    coord = np.stack([vertex["x"], vertex["y"], vertex["z"]],
                     axis=1).astype(np.float32)
    color = np.stack([vertex["red"], vertex["green"], vertex["blue"]],
                     axis=1).astype(np.float32)
    return dict(coord=coord, color=color,
                normal=vertex_normals(coord, faces).astype(np.float32))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset-root", required=True,
                    help="ARKitScenes root containing 3dod/<split>/<id>/")
    ap.add_argument("--output-root", required=True)
    args = ap.parse_args(argv)
    meshes = sorted(glob.glob(
        os.path.join(args.dataset_root, "3dod", "*", "*", "*_mesh.ply")))
    if not meshes:
        raise SystemExit(f"no 3dod meshes under {args.dataset_root}")
    for path in meshes:
        split = os.path.basename(os.path.dirname(os.path.dirname(path)))
        scene_id = os.path.basename(os.path.dirname(path))
        out_dir = os.path.join(args.output_root, split)
        os.makedirs(out_dir, exist_ok=True)
        data = convert_mesh(path)
        np.savez(os.path.join(out_dir, f"{scene_id}.npz"), **data)
        print(f"{split}/{scene_id}: {data['coord'].shape[0]} vertices")


if __name__ == "__main__":
    main()
