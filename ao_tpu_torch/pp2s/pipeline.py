"""PP2S offline preprocessing pipeline orchestration (port of
ao_tpu/pp2s/pipeline.py).

Runs the five stages end to end over an S3DIS-style layout
(reference call stack: SURVEY.md §3.5):

  data/s3dis/<area>/<room>.pth        preprocessed rooms
  data/S2D3D/<area>/data/{rgb,depth,pose}/   panorama-derived frames
  used_imgs/<area>/<room>.txt          frame list per room
  data/align_angle_and_center/<area>.txt

producing

  data/embeddings/<area>/<room>/<frame>.npz   SAM image features
  data/bridge/<area>/<room>/<frame>.npy       point<->pixel bridges
  data/weak_labels/<area>/<room>.npy          1-point-per-instance mask
  data/sam_labels/<area>/<room>.npy           dense pseudo-labels
  data/basket_s3dis.pickle                    REAL logit basket

The SAM image encoder runs on the pipeline's ``device`` (the card by
default; ``models/sam/predictor.py``); bridges, weak labels and the oracle
are vectorised numpy. Frames are read and written through Pillow.
``stage_seconds`` keeps the wall seconds of each stage that ran.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np

from ..datasets.defaults import load_scene
from ..utils.logger import get_root_logger

from .projection import (
    align_room,
    compute_bridge,
    project_points,
    splat_raster,
)
from .labels import (
    choose_weak_labels,
    make_basket,
    run_sam_labels_for_scene,
    save_basket,
)

AREAS = ("Area_1", "Area_2", "Area_3", "Area_4", "Area_6")


class PP2SPipeline:
    def __init__(
        self,
        data_root: str = "data",
        sam_checkpoint: Optional[str] = None,
        sam_model_type: str = "vit_h",
        areas=AREAS,
        num_classes: int = 13,
        depth_divisor: float = 512.0,
        sam_oracle: bool = False,
        oracle_quality: float = 0.7,
        bridge_depth_thresh: float = 0.1,
        device="cuda",
    ):
        self.data_root = data_root
        self.device = device
        self.stage_seconds: Dict[str, float] = {}
        self.areas = areas
        self.num_classes = num_classes
        self.depth_divisor = depth_divisor
        # visibility depth test (reference my_make_bridge_final.py:141
        # uses 0.1 m on real captures; the synthetic proxy's splat depth
        # is exact to ~0.004 m surface jitter, and its wall fixtures sit
        # only 0.03 m proud — the calibrated proxy equivalent is 0.02)
        self.bridge_depth_thresh = float(bridge_depth_thresh)
        self.logger = get_root_logger()
        self._predictor = None
        self._sam_checkpoint = sam_checkpoint
        self._sam_model_type = sam_model_type
        # oracle mode (models/sam/oracle.py): stage 1 rasterises GT
        # instance-id maps as the "embeddings" and the predictor decodes
        # masks from them — for environments without SAM weights
        self.sam_oracle = sam_oracle
        self.oracle_quality = oracle_quality

    # ---- paths ----
    def _p(self, *parts):
        return os.path.join(self.data_root, *parts)

    def rooms(self, area: str) -> List[str]:
        return sorted(
            os.path.splitext(os.path.basename(p))[0]
            for p in glob.glob(self._p("s3dis", area, "*.pth"))
            + glob.glob(self._p("s3dis", area, "*.npz"))
        )

    def frames(self, area: str, room: str) -> List[str]:
        lst = self._p("..", "used_imgs", area, room + ".txt")
        alt = self._p("used_imgs", area, room + ".txt")
        path = lst if os.path.isfile(lst) else alt
        if not os.path.isfile(path):
            return []
        with open(path) as f:
            return [
                os.path.splitext(os.path.basename(line.strip()))[0]
                for line in f if line.strip()
            ]

    def alignment(self, area: str) -> Dict[str, tuple]:
        path = self._p("align_angle_and_center", area + ".txt")
        out = {}
        if not os.path.isfile(path):
            return out
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 5:
                    out[parts[0]] = (
                        float(parts[1]),
                        np.array([float(parts[2]), float(parts[3]),
                                  float(parts[4])]),
                    )
        return out

    def pose(self, area: str, frame: str):
        path = self._p("S2D3D", area, "data", "pose", frame.replace("rgb", "pose") + ".json")
        with open(path) as f:
            pose = json.load(f)
        return np.array(pose["camera_k_matrix"]), np.array(pose["camera_rt_matrix"])

    def load_room(self, area: str, room: str) -> dict:
        for ext in (".pth", ".npz"):
            p = self._p("s3dis", area, room + ext)
            if os.path.isfile(p):
                return load_scene(p)
        raise FileNotFoundError(f"{area}/{room}")

    def aligned_coord(self, area: str, room: str, data: dict) -> np.ndarray:
        coord = np.asarray(data["coord"], np.float32)
        align = self.alignment(area)
        if room in align:
            angle, center = align[room]
            coord = align_room(coord.copy(), angle, center)
        return coord

    @property
    def predictor(self):
        if self._predictor is None:
            if self.sam_oracle:
                from ..models.sam import OracleSamPredictor

                self._predictor = OracleSamPredictor(
                    quality=self.oracle_quality
                )
            else:
                from ..models.sam import (
                    SamConfig, SamPredictor, load_sam_checkpoint,
                )

                cfg = getattr(
                    SamConfig, self._sam_model_type.replace("-", "_")
                )()
                state_dict = None
                if self._sam_checkpoint:
                    state_dict = load_sam_checkpoint(self._sam_checkpoint)
                self._predictor = SamPredictor(cfg, state_dict,
                                               device=self.device)
        return self._predictor

    # ---- stage 1: SAM embeddings ----
    def run_embeddings(self):
        from PIL import Image

        for area in self.areas:
            for room in self.rooms(area):
                data = self.load_room(area, room)
                out_dir = self._p("embeddings", area, room)
                os.makedirs(out_dir, exist_ok=True)
                for frame in self.frames(area, room):
                    out = os.path.join(out_dir, frame + ".npz")
                    if os.path.isfile(out):
                        continue
                    rgb_path = self._p("S2D3D", area, "data", "rgb", frame + ".png")
                    img = np.asarray(Image.open(rgb_path))[..., :3]
                    if self.sam_oracle:
                        # per-pixel GT instance ids under the SAME splat
                        # z-buffer as the rendered frames, stored in the
                        # embedding cache slot (models/sam/oracle.py)
                        coord = self.aligned_coord(area, room, data)
                        iid = np.asarray(
                            data["instance_gt"], np.int32
                        ).reshape(-1)
                        k, rt = self.pose(area, frame)
                        id_map, _ = splat_raster(
                            coord, iid, k, rt, img.shape[:2], splat=2,
                            background=np.int32(-1),
                        )
                        np.savez_compressed(out, features=id_map)
                    else:
                        feats = self.predictor.set_image(img)
                        np.savez_compressed(out, features=feats[0].cpu().numpy())
                self.logger.info(f"embeddings done: {area}/{room}")

    # ---- stage 2: bridges ----
    def run_bridges(self):
        from PIL import Image

        for area in self.areas:
            for room in self.rooms(area):
                data = self.load_room(area, room)
                coord = self.aligned_coord(area, room, data)
                out_dir = self._p("bridge", area, room)
                os.makedirs(out_dir, exist_ok=True)
                for frame in self.frames(area, room):
                    out = os.path.join(out_dir, frame + ".npy")
                    if os.path.isfile(out):
                        continue
                    k, rt = self.pose(area, frame)
                    depth_path = self._p(
                        "S2D3D", area, "data", "depth",
                        frame.replace("rgb", "depth") + ".png",
                    )
                    depth = (
                        np.asarray(Image.open(depth_path)) / self.depth_divisor
                    )
                    bridge = compute_bridge(
                        coord, k, rt, depth,
                        depth_thresh=self.bridge_depth_thresh,
                    )
                    if bridge[:, 2].any():
                        np.save(out, bridge)
                self.logger.info(f"bridges done: {area}/{room}")


    # ---- stage 0 (rendering variant): synthesise frames from points ----
    def run_render_frames(self, views: int = 6, size: int = 512,
                          splat: int = 2):
        """Rendering-based PP2S (reference: my_run_sam_render.py +
        my_decode_embedding_rendering.py — research drafts that feed SAM
        point-cloud renderings instead of real captures). Rasterises each
        room's coloured points from ``views`` synthetic viewpoints with a
        z-buffer splat and writes rgb/depth/pose files in the exact
        S2D3D layout, so embeddings/bridges/labels run unchanged on the
        rendered frames."""
        import json as _json

        from PIL import Image

        f = 0.8 * size
        K = np.array([[f, 0, (size + 1) / 2],
                      [0, f, (size + 1) / 2],
                      [0, 0, 1.0]])
        for area in self.areas:
            for room in self.rooms(area):
                data = self.load_room(area, room)
                coord = self.aligned_coord(area, room, data)
                if "color" in data and np.size(data["color"]):
                    color = np.asarray(data["color"], np.float32)
                else:
                    color = np.full_like(coord, 127.0)
                if color.max() <= 1.0:
                    color = color * 255.0
                lo, hi = coord.min(0), coord.max(0)
                center = (lo + hi) / 2
                radius = float(np.linalg.norm((hi - lo)[:2]) / 2) + 1e-3
                eye_z = lo[2] + 0.8 * (hi[2] - lo[2])
                # ring views + two vertical views (straight up from low
                # centre, straight down from below the ceiling): real
                # panorama captures see ceilings and floors; a
                # horizontal-only rig leaves them unprompted and the
                # big planar classes end up unlabelled
                rig = []
                for v in range(views):
                    yaw = 2 * np.pi * v / views
                    eye = np.array([
                        center[0] + 0.35 * radius * np.cos(yaw),
                        center[1] + 0.35 * radius * np.sin(yaw),
                        eye_z,
                    ])
                    rig.append((eye, center, np.array([0.0, 0.0, 1.0])))
                zlo = np.array([center[0], center[1], lo[2] + 0.25 * (hi[2] - lo[2])])
                zhi = np.array([center[0], center[1], hi[2] - 0.1 * (hi[2] - lo[2])])
                rig.append((zlo, zlo + np.array([0.0, 0.0, 1.0]),
                            np.array([1.0, 0.0, 0.0])))  # up: ceiling
                rig.append((zhi, zhi - np.array([0.0, 0.0, 1.0]),
                            np.array([1.0, 0.0, 0.0])))  # down: floor
                frames = []
                for v, (eye, target, up) in enumerate(rig):
                    look = target - eye
                    look = look / (np.linalg.norm(look) + 1e-9)
                    right = np.cross(look, up)
                    right /= np.linalg.norm(right) + 1e-9
                    down = np.cross(look, right)
                    R = np.stack([right, down, look])  # world -> cam rows
                    t = -R @ eye
                    rt = np.concatenate([R, t[:, None]], axis=1)
                    # shared splat z-buffer (projection.py splat_raster) —
                    # the oracle id maps rasterise identically
                    rgb, depth = splat_raster(
                        coord, color.astype(np.uint8), K, rt,
                        (size, size), splat=splat,
                    )
                    frame = f"camera_render{v:02d}_{room}_rgb"
                    rgb_dir = self._p("S2D3D", area, "data", "rgb")
                    dep_dir = self._p("S2D3D", area, "data", "depth")
                    pose_dir = self._p("S2D3D", area, "data", "pose")
                    for d in (rgb_dir, dep_dir, pose_dir):
                        os.makedirs(d, exist_ok=True)
                    Image.fromarray(rgb).save(
                        os.path.join(rgb_dir, frame + ".png")
                    )
                    d16 = np.clip(
                        depth * self.depth_divisor, 0, 65535
                    ).astype(np.uint16)
                    # a uint16 array is a 16-bit grey ("I;16") image
                    Image.fromarray(d16).save(
                        os.path.join(
                            dep_dir, frame.replace("rgb", "depth") + ".png"
                        )
                    )
                    with open(os.path.join(
                        pose_dir, frame.replace("rgb", "pose") + ".json"
                    ), "w") as fh:
                        _json.dump({
                            "camera_k_matrix": K.tolist(),
                            "camera_rt_matrix": rt.tolist(),
                        }, fh)
                    frames.append(frame)
                lst_dir = self._p("used_imgs", area)
                os.makedirs(lst_dir, exist_ok=True)
                with open(os.path.join(lst_dir, room + ".txt"), "w") as fh:
                    fh.write("\n".join(frame + ".png" for frame in frames))
                self.logger.info(
                    f"rendered {len(rig)} frames: {area}/{room}"
                )

    # ---- stage 3: weak labels ----
    def run_weak_labels(self):
        for area in self.areas:
            os.makedirs(self._p("weak_labels", area), exist_ok=True)
            for room in self.rooms(area):
                out = self._p("weak_labels", area, room + ".npy")
                if os.path.isfile(out):
                    continue
                data = self.load_room(area, room)
                instance = np.asarray(data["instance_gt"], np.int64).reshape(-1)
                viewable = np.zeros_like(instance)
                for bp in glob.glob(self._p("bridge", area, room, "*.npy")):
                    bridge = np.load(bp)
                    viewable[bridge[:, 2] == 1] = 1
                np.save(out, choose_weak_labels(instance, viewable))
                self.logger.info(f"weak labels done: {area}/{room}")

    # ---- stage 4: basket ----
    def run_basket(self, out_name: str = "basket_s3dis.pickle"):
        sizes = {}
        for area in self.areas:
            for room in self.rooms(area):
                data = self.load_room(area, room)
                sizes[f"{area}/{room}"] = np.asarray(data["coord"]).shape[0]
        save_basket(make_basket(sizes, self.num_classes), self._p(out_name))
        self.logger.info(f"basket saved: {len(sizes)} scenes")

    # ---- stage 5: SAM labels ----
    def run_sam_labels(self, frame_size=(1080, 1080)):
        for area in self.areas:
            os.makedirs(self._p("sam_labels", area), exist_ok=True)
            for room in self.rooms(area):
                out = self._p("sam_labels", area, room + ".npy")
                if os.path.isfile(out):
                    continue
                data = self.load_room(area, room)
                coord = np.asarray(data["coord"], np.float32)
                segment = np.asarray(data["semantic_gt"], np.int64).reshape(-1)
                weak = np.load(self._p("weak_labels", area, room + ".npy"))
                bridges = {
                    os.path.splitext(os.path.basename(p))[0]: np.load(p)
                    for p in glob.glob(self._p("bridge", area, room, "*.npy"))
                }
                embeddings = {}
                for p in glob.glob(self._p("embeddings", area, room, "*.npz")):
                    with np.load(p) as z:
                        embeddings[
                            os.path.splitext(os.path.basename(p))[0]
                        ] = z["features"]
                if bridges and embeddings:
                    labels = run_sam_labels_for_scene(
                        self.predictor, coord, segment, weak, bridges,
                        embeddings, frame_size, self.num_classes,
                    )
                else:
                    # no frames: only the weak points carry labels
                    labels = -np.ones(coord.shape[0], np.int32)
                    wi = np.where((weak == 1) & (segment != -1))[0]
                    labels[wi] = segment[wi].astype(np.int32)
                np.save(out, labels.reshape(-1, 1))
                self.logger.info(f"sam labels done: {area}/{room}")

    def run_stage(self, stage: str, **kwargs):
        """``run_<stage>(**kwargs)``, its wall seconds kept in
        ``stage_seconds``."""
        t = time.perf_counter()
        getattr(self, f"run_{stage}")(**kwargs)
        self.stage_seconds[stage] = time.perf_counter() - t
        self.logger.info(f"stage {stage}: {self.stage_seconds[stage]:.2f} s")

    def run_all(self, frame_size=(1080, 1080)):
        self.run_stage("embeddings")
        self.run_stage("bridges")
        self.run_stage("weak_labels")
        self.run_stage("basket")
        self.run_stage("sam_labels", frame_size=frame_size)
