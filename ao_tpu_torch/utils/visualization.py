"""Point-cloud dumps as PLY for inspection (port of
ao_tpu/utils/visualization.py; reference: pointcept/utils/visualization.py):
coloured clouds, label clouds in a 20-colour palette, and bounding boxes
as their corner points."""

from __future__ import annotations

import os

import numpy as np

from .ply import write_ply

_LABEL_COLORS = np.array(
    [
        [174, 199, 232], [152, 223, 138], [31, 119, 180], [255, 187, 120],
        [188, 189, 34], [140, 86, 75], [255, 152, 150], [214, 39, 40],
        [197, 176, 213], [148, 103, 189], [196, 156, 148], [23, 190, 207],
        [247, 182, 210], [219, 219, 141], [255, 127, 14], [158, 218, 229],
        [44, 160, 44], [112, 128, 144], [227, 119, 194], [82, 84, 163],
    ],
    dtype=np.uint8,
)


def save_point_cloud(coord, color=None, file_path="pc.ply", logger=None):
    """``coord`` (N, 3) with ``color`` (N, 3): uint8 as is, floats in [0, 1]
    scaled to 0-255, other values clipped to 0-255; grey when None."""
    os.makedirs(os.path.dirname(os.path.abspath(file_path)), exist_ok=True)
    coord = np.asarray(coord, np.float32)
    if color is None:
        color = np.full_like(coord, 127, dtype=np.uint8)
    color = np.asarray(color)
    if color.dtype != np.uint8:
        color = ((np.clip(color, 0, 1) * 255).astype(np.uint8)
                 if color.max() <= 1 else np.clip(color, 0, 255).astype(np.uint8))
    write_ply(file_path, [coord, color], ["x", "y", "z", "red", "green", "blue"])
    if logger is not None:
        logger.info(f"Saved point cloud: {file_path}")


def save_label_cloud(coord, labels, file_path="labels.ply", ignore_index=-1,
                     logger=None):
    """Each point in its label's palette colour, black where ignored."""
    labels = np.asarray(labels).reshape(-1)
    color = np.zeros((len(labels), 3), np.uint8)
    valid = labels != ignore_index
    color[valid] = _LABEL_COLORS[labels[valid] % len(_LABEL_COLORS)]
    save_point_cloud(coord, color, file_path, logger)


def save_bounding_boxes(bboxes, file_path="bbox.ply", logger=None):
    """``bboxes`` (M, 6) as [x0 y0 z0 x1 y1 z1], saved as their 8 corners
    each (x, then y, then z slowest to fastest)."""
    bboxes = np.asarray(bboxes, np.float32).reshape(-1, 6)
    corners = [[x, y, z] for x0, y0, z0, x1, y1, z1 in bboxes
               for x in (x0, x1) for y in (y0, y1) for z in (z0, z1)]
    save_point_cloud(np.asarray(corners, np.float32).reshape(-1, 3), None,
                     file_path, logger)
