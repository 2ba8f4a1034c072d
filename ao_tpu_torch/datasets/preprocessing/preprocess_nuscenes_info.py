"""nuScenes lidarseg info-pickle builder (port of
ao_tpu/datasets/preprocessing/preprocess_nuscenes_info.py; reference:
pointcept/datasets/preprocessing/nuscenes/
preprocess_nuscenes_info.py:312-607). The reference drives the
nuscenes-devkit; this version parses the database's plain-JSON tables
directly (scene / sample / sample_data / calibrated_sensor / ego_pose /
lidarseg), so no devkit install is needed. For every keyframe LIDAR_TOP
sample it emits:

    {lidar_token, lidar_path, gt_segment_path?, timestamp, token,
     sweeps: [{lidar_path, sample_data_token, timestamp,
               sensor2lidar_rotation (3,3), sensor2lidar_translation (3,)}
              x (max_sweeps - 1)]}

written as ``nuscenes_infos_<k>sweeps_{train,val,test}.pkl`` under
``<output>/info`` — the layout ``datasets/nuscenes.py``'s NuScenesDataset
consumes. Scene splits come from the official devkit lists when the
devkit is importable, otherwise from ``--train-scenes/--val-scenes``
files (one scene name per line); the v1.0-mini splits are built in.

Usage:
    python -m ao_tpu_torch.datasets.preprocessing.preprocess_nuscenes_info \
        --dataset-root data/nuscenes/raw --output-root data/nuscenes \
        --version v1.0-trainval --max-sweeps 10
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np

MINI_TRAIN = [
    "scene-0061", "scene-0553", "scene-0655", "scene-0757", "scene-0796",
    "scene-1077", "scene-1094", "scene-1100",
]
MINI_VAL = ["scene-0103", "scene-0916"]


def _quat_to_rot(q):
    """Unit quaternion (w, x, y, z) -> 3x3 rotation matrix."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float64,
    )


def _pose_mat(record):
    """ego_pose / calibrated_sensor record -> 4x4 homogeneous matrix."""
    m = np.eye(4)
    m[:3, :3] = _quat_to_rot(record["rotation"])
    m[:3, 3] = record["translation"]
    return m


class NuScenesTables:
    """Token-indexed view over the database's JSON tables."""

    def __init__(self, dataset_root, version):
        self.root = dataset_root
        tdir = os.path.join(dataset_root, version)

        def load(name, optional=False):
            path = os.path.join(tdir, f"{name}.json")
            if optional and not os.path.isfile(path):
                return {}
            with open(path) as f:
                return {r["token"]: r for r in json.load(f)}

        self.scene = load("scene")
        self.sample = load("sample")
        self.sample_data = load("sample_data")
        self.calibrated_sensor = load("calibrated_sensor")
        self.ego_pose = load("ego_pose")
        self.lidarseg = load("lidarseg", optional=True)

    def keyframe_lidar(self, sample_token):
        """The LIDAR_TOP keyframe sample_data of a sample."""
        for sd in self.sample_data.values():
            if (
                sd["sample_token"] == sample_token
                and sd["is_key_frame"]
                and "LIDAR_TOP" in sd["filename"].upper().replace("/", "_")
            ):
                return sd
        raise KeyError(f"no LIDAR_TOP keyframe for sample {sample_token}")

    def global_from_lidar(self, sd):
        return _pose_mat(self.ego_pose[sd["ego_pose_token"]]) @ _pose_mat(
            self.calibrated_sensor[sd["calibrated_sensor_token"]]
        )


def build_infos(tables: NuScenesTables, scene_names, max_sweeps=10,
                with_lidarseg=True):
    name_to_scene = {s["name"]: s for s in tables.scene.values()}
    infos = []
    for name in sorted(scene_names):
        if name not in name_to_scene:
            continue
        sample_token = name_to_scene[name]["first_sample_token"]
        while sample_token:
            sample = tables.sample[sample_token]
            ref_sd = tables.keyframe_lidar(sample_token)
            ref_from_global = np.linalg.inv(tables.global_from_lidar(ref_sd))
            info = dict(
                token=sample_token,
                lidar_token=ref_sd["token"],
                lidar_path=ref_sd["filename"],
                timestamp=ref_sd["timestamp"],
                sweeps=[],
            )
            if with_lidarseg and ref_sd["token"] in tables.lidarseg:
                info["gt_segment_path"] = tables.lidarseg[
                    ref_sd["token"]
                ]["filename"]
            # walk the prev chain for non-keyframe sweeps, transforming
            # each into the reference lidar frame; short chains repeat the
            # last sweep (reference :393-452)
            sd = ref_sd
            while len(info["sweeps"]) < max_sweeps - 1:
                if sd["prev"]:
                    sd = tables.sample_data[sd["prev"]]
                    rel = ref_from_global @ tables.global_from_lidar(sd)
                    info["sweeps"].append(
                        dict(
                            lidar_path=sd["filename"],
                            sample_data_token=sd["token"],
                            timestamp=sd["timestamp"],
                            sensor2lidar_rotation=rel[:3, :3],
                            sensor2lidar_translation=rel[:3, 3],
                        )
                    )
                elif info["sweeps"]:
                    info["sweeps"].append(info["sweeps"][-1])
                else:
                    # chain exhausted immediately: the reference pads with
                    # the keyframe itself (identity transform, :396-405)
                    info["sweeps"].append(
                        dict(
                            lidar_path=ref_sd["filename"],
                            sample_data_token=ref_sd["token"],
                            timestamp=ref_sd["timestamp"],
                            sensor2lidar_rotation=np.eye(3),
                            sensor2lidar_translation=np.zeros(3),
                        )
                    )
            infos.append(info)
            sample_token = sample["next"]
    return infos


def official_splits(version):
    """Scene-name lists per split: devkit if present, built-in for mini."""
    if version == "v1.0-mini":
        return MINI_TRAIN, MINI_VAL
    try:
        from nuscenes.utils import splits  # gated optional dependency

        if version == "v1.0-test":
            return splits.test, []
        return splits.train, splits.val
    except ImportError:
        return None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset-root", required=True,
                    help="nuScenes raw root (holds v1.0-*/ and samples/)")
    ap.add_argument("--output-root", required=True)
    ap.add_argument("--version", default="v1.0-trainval")
    ap.add_argument("--max-sweeps", type=int, default=10)
    ap.add_argument("--train-scenes", help="file of scene names (no devkit)")
    ap.add_argument("--val-scenes", help="file of scene names (no devkit)")
    args = ap.parse_args(argv)

    tables = NuScenesTables(args.dataset_root, args.version)
    if args.train_scenes:
        with open(args.train_scenes) as f:
            train = [l.strip() for l in f if l.strip()]
        val = []
        if args.val_scenes:
            with open(args.val_scenes) as f:
                val = [l.strip() for l in f if l.strip()]
    else:
        got = official_splits(args.version)
        if got is None:
            raise SystemExit(
                "nuscenes-devkit not installed: pass --train-scenes / "
                "--val-scenes files for non-mini versions"
            )
        train, val = got

    out = os.path.join(args.output_root, "info")
    os.makedirs(out, exist_ok=True)
    is_test = args.version == "v1.0-test"
    jobs = [("test", train)] if is_test else [("train", train), ("val", val)]
    for split, scenes in jobs:
        infos = build_infos(
            tables, scenes, args.max_sweeps, with_lidarseg=not is_test
        )
        path = os.path.join(
            out, f"nuscenes_infos_{args.max_sweeps}sweeps_{split}.pkl"
        )
        with open(path, "wb") as f:
            pickle.dump(infos, f)
        print(f"{split}: {len(infos)} samples -> {path}")


if __name__ == "__main__":
    main()
