"""Micro raw inputs of the dataset preprocessors (numpy, Pillow and the
port's PLY writer only), shared by tests/test_torch_preprocessing.py and
the isolation test: raw S3DIS rooms, a ScanNet scan (ply, segment and
aggregation json, label tsv), a Structured3D zip (one perspective frame,
one panorama), an ArkitScenes 3dod mesh, and a nuScenes JSON database.
The last three follow the builders of tests/test_data.py; the S3DIS
rooms are written by chip_smoke.write_raw_s3dis."""

import io
import json
import os
import zipfile

import numpy as np

# raw labels and their ids: wall (a ScanNet-20 class), lamp (ScanNet-200
# only), object (neither)
SCANNET_TSV = (("wall", 1), ("chair", 5), ("lamp", 13), ("object", 400))


def write_scannet_scene(root, scene="scene0000_00", n=200, seed=0):
    """One scan under ``<root>/scans/<scene>/`` with its label tsv at
    ``<root>/labels.tsv``: a coloured vertex ply, 10 over-segments, and
    four annotated groups (a ScanNet-20 class, a ScanNet-200-only class,
    an unknown label and a class of neither), one segment left out."""
    from ao_tpu_torch.utils.ply import write_ply

    rng = np.random.default_rng(seed)
    d = os.path.join(root, "scans", scene)
    os.makedirs(d, exist_ok=True)
    coord = rng.uniform(0, 3, (n, 3)).astype(np.float32)
    color = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    write_ply(os.path.join(d, f"{scene}_vh_clean_2.ply"),
              [coord, color, np.full(n, 255, np.uint8)],
              ["x", "y", "z", "red", "green", "blue", "alpha"])
    segs = rng.integers(0, 10, n)
    with open(os.path.join(d, f"{scene}_vh_clean_2.0.010000.segs.json"), "w") as f:
        json.dump({"segIndices": segs.tolist()}, f)
    groups = [dict(label="wall", segments=[0, 1, 2]),
              dict(label="lamp", segments=[3, 4]),
              dict(label="unknown thing", segments=[5]),
              dict(label="object", segments=[6, 7])]
    with open(os.path.join(d, f"{scene}.aggregation.json"), "w") as f:
        json.dump({"segGroups": groups}, f)
    with open(os.path.join(root, "labels.tsv"), "w") as f:
        f.write("id\traw_category\tcategory\n")
        for name, i in SCANNET_TSV:
            f.write(f"{i}\t{name}\t{name}\n")
    return os.path.join(root, "scans"), os.path.join(root, "labels.tsv")


def _png(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def write_structured3d_zip(root):
    """tests/test_data.py's Structured3D zip: scene_00001, room 42, one
    perspective frame and one panorama of a wall 2 m away."""
    H, W = 24, 32
    depth = np.full((H, W), 2000, np.uint16)
    rgb = np.full((H, W, 3), 120, np.uint8)
    sem = np.full((H, W), 1, np.uint8)
    os.makedirs(root, exist_ok=True)
    with zipfile.ZipFile(os.path.join(root, "Structured3D_00.zip"), "w") as z:
        base = "Structured3D/scene_00001/2D_rendering/42"
        p = f"{base}/perspective/full/0"
        z.writestr(f"{p}/camera_pose.txt", "0 0 1000 1 0 0 0 1 0 0.8 0.6")
        z.writestr(f"{p}/depth.png", _png(depth))
        z.writestr(f"{p}/rgb_rawlight.png", _png(rgb))
        z.writestr(f"{p}/semantic.png", _png(sem))
        pano = f"{base}/panorama"
        z.writestr(f"{pano}/camera_xyz.txt", "0 0 1000")
        z.writestr(f"{pano}/full/depth.png", _png(depth))
        z.writestr(f"{pano}/full/rgb_rawlight.png", _png(rgb))
        z.writestr(f"{pano}/full/semantic.png", _png(sem))
    return root


def write_arkitscenes_mesh(root):
    """tests/test_data.py's ArkitScenes mesh (a unit square of two faces)
    under ``<root>/3dod/Training/41069021/``, and a second, folded mesh
    under Validation."""
    from ao_tpu_torch.utils.ply import write_ply

    coord = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    color = np.full((4, 3), 128, np.uint8)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    for split, scene, c in (("Training", "41069021", coord),
                            ("Validation", "42000001",
                             coord + np.array([[0, 0, 0], [0, 0, 0.5],
                                               [0, 0, 0], [0, 0, 0.3]],
                                              np.float32))):
        d = os.path.join(root, "3dod", split, scene)
        os.makedirs(d, exist_ok=True)
        write_ply(os.path.join(d, f"{scene}_3dod_mesh.ply"),
                  [c, color[:, 0], color[:, 1], color[:, 2]],
                  ["x", "y", "z", "red", "green", "blue"],
                  triangular_faces=faces)
    return root


def write_nuscenes_db(root):
    """tests/test_data.py's micro nuScenes database (v1.0-mini: one scene
    of two samples, a sweep between them, lidarseg of the first), with a
    rotated, translated ego pose."""
    os.makedirs(os.path.join(root, "v1.0-mini"), exist_ok=True)
    ident = dict(rotation=[1, 0, 0, 0], translation=[0, 0, 0])
    pose = dict(rotation=[0.9238795, 0, 0, 0.3826834],
                translation=[1.5, -2.0, 0.25])

    def write(name, rows):
        with open(os.path.join(root, "v1.0-mini", f"{name}.json"), "w") as f:
            json.dump(rows, f)

    write("scene", [dict(token="sc0", name="scene-0061",
                         first_sample_token="sa0")])
    write("sample", [dict(token="sa0", next="sa1", prev=""),
                     dict(token="sa1", next="", prev="sa0")])
    sds = []
    for i, (tok, sample, key, prev, ep) in enumerate([
            ("sd0", "sa0", True, "", "ep0"),
            ("sd0s", "sa0", False, "sd0", "ep1"),
            ("sd1", "sa1", True, "sd0s", "ep1")]):
        fname = (f"samples/LIDAR_TOP/{tok}.pcd.bin" if key
                 else f"sweeps/LIDAR_TOP/{tok}.pcd.bin")
        sds.append(dict(token=tok, sample_token=sample, is_key_frame=key,
                        filename=fname, prev=prev, timestamp=1000 + i,
                        ego_pose_token=ep, calibrated_sensor_token="cs0"))
        path = os.path.join(root, fname)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.random.default_rng(i).normal(size=(50, 5)).astype(np.float32).tofile(path)
    write("sample_data", sds)
    write("ego_pose", [dict(token="ep0", **ident), dict(token="ep1", **pose)])
    write("calibrated_sensor", [dict(token="cs0", **ident)])
    os.makedirs(os.path.join(root, "lidarseg"), exist_ok=True)
    np.random.default_rng(9).integers(0, 31, 50).astype(np.uint8).tofile(
        os.path.join(root, "lidarseg", "sd0.bin"))
    write("lidarseg", [dict(token="sd0", filename="lidarseg/sd0.bin")])
    return root
