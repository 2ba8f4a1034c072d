"""Point->pixel projection and visibility (PP2S stages 1-2; a copy of
ao_tpu/pp2s/projection.py, numpy only).

Vectorised numpy equivalents of the reference's per-frame loops
(reference: pointcept/utils/my_decode_embedding_final.py:63-89 room
alignment + pinhole projection; my_make_bridge_final.py:103-155 depth-test
bridges). A "bridge" for a frame is an (N, 3) array [u, v, visible]: the
pixel each point projects to and whether it passes the |z_pred - z_gt| <
0.1 depth test against the frame's GT depth map.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def align_room(coord: np.ndarray, angle_deg: float, center: np.ndarray) -> np.ndarray:
    """Rotate a room cloud about z around ``center`` by the S2D3D alignment
    angle (reference formula: my_decode_embedding_final.py:65-70)."""
    angle = 360.0 - angle_deg
    angle = (2.0 - angle / 180.0) * np.pi
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], coord.dtype)
    return (coord - center) @ rot.T + center


def project_points(
    coord: np.ndarray,  # (N, 3) aligned world coords
    k_matrix: np.ndarray,  # (3, 3) intrinsics
    rt_matrix: np.ndarray,  # (3, 4) extrinsics [R|t]
) -> Tuple[np.ndarray, np.ndarray]:
    """Pinhole projection. Returns (pixel (N, 2) rounded [u, v], z (N,)
    camera-frame depth)."""
    homo = np.concatenate([coord, np.ones((coord.shape[0], 1), coord.dtype)], 1)
    cam = homo @ np.concatenate([rt_matrix, [[0, 0, 0, 1]]]).T  # (N, 4)
    img = homo @ (k_matrix @ rt_matrix).T  # (N, 3)
    with np.errstate(divide="ignore", invalid="ignore"):
        pix = np.round(img / img[:, 2:3])
    return pix[:, :2], cam[:, 2]


def compute_bridge(
    coord: np.ndarray,  # (N, 3) aligned coords
    k_matrix: np.ndarray,
    rt_matrix: np.ndarray,
    depth_map: np.ndarray,  # (H, W) metric depth (reference: png/512)
    depth_thresh: float = 0.1,
) -> np.ndarray:
    """(N, 3) uint16 [u, v, visible] bridge for one frame
    (reference: my_make_bridge_final.py:126-150)."""
    n = coord.shape[0]
    height = k_matrix[0, 2] * 2 - 1
    width = k_matrix[1, 2] * 2 - 1
    pix, z = project_points(coord, k_matrix, rt_matrix)
    in_frame = (
        (pix[:, 0] > 0) & (pix[:, 1] > 0)
        & (pix[:, 0] < height) & (pix[:, 1] < width)
        & np.isfinite(pix).all(1)
    )
    idx = np.where(in_frame)[0]
    bridge = np.zeros((n, 3), np.uint16)
    if idx.size == 0:
        return bridge
    uv = pix[idx].astype(np.int64)
    depth_gt = depth_map[uv[:, 1], uv[:, 0]]
    visible = np.abs(depth_gt - z[idx]) < depth_thresh
    vis_idx = idx[visible]
    bridge[vis_idx, 0] = uv[visible, 0].astype(np.uint16)
    bridge[vis_idx, 1] = uv[visible, 1].astype(np.uint16)
    bridge[vis_idx, 2] = 1
    return bridge


def splat_raster(
    coord: np.ndarray,  # (N, 3) aligned world coords
    values: np.ndarray,  # (N,) or (N, D) per-point values to paint
    k_matrix: np.ndarray,
    rt_matrix: np.ndarray,
    size: Tuple[int, int],  # (H, W)
    splat: int = 2,
    background=0,
    z_near: float = 0.1,
):
    """Far-to-near z-buffer splat of per-point ``values`` into an image.

    Every point paints a (2*splat+1)^2 pixel block; overlapping splats
    resolve by a single global far-to-near ordered write (per-offset
    passes would let a later pass overwrite a near pixel with a far
    point's splat). This is the one rasteriser behind both the PP2S
    rendering variant's rgb/depth frames and the oracle-SAM per-pixel
    instance-id maps, so their visibility is bit-identical.

    Returns (img (H, W) or (H, W, D), depth (H, W) float64 with 0 = no
    point)."""
    h, w = size
    vals = np.asarray(values)
    pix, z = project_points(coord, k_matrix, rt_matrix)
    keep = (
        (z > z_near)
        & np.isfinite(pix).all(1)
        & (pix[:, 0] >= 0) & (pix[:, 0] < w)
        & (pix[:, 1] >= 0) & (pix[:, 1] < h)
    )
    ui = pix[keep, 0].astype(np.int64)
    vi = pix[keep, 1].astype(np.int64)
    zk = z[keep]
    ck = vals[keep]
    offs = [
        (dy, dx)
        for dy in range(-splat, splat + 1)
        for dx in range(-splat, splat + 1)
    ]
    yy = np.concatenate([np.clip(vi + dy, 0, h - 1) for dy, _ in offs])
    xx = np.concatenate([np.clip(ui + dx, 0, w - 1) for _, dx in offs])
    zz = np.tile(zk, len(offs))
    cc = np.tile(ck, (len(offs),) + (1,) * (ck.ndim - 1))
    order = np.argsort(-zz, kind="stable")
    img_shape = (h, w) + vals.shape[1:]
    img = np.full(img_shape, background, vals.dtype)
    depth = np.zeros((h, w), np.float64)
    img[yy[order], xx[order]] = cc[order]
    depth[yy[order], xx[order]] = zz[order]
    return img, depth


def render_depth_map(
    coord: np.ndarray,
    k_matrix: np.ndarray,
    rt_matrix: np.ndarray,
    shape: Tuple[int, int],
) -> np.ndarray:
    """Z-buffer a point cloud into a depth map (used to synthesise GT depth
    for tests and for datasets that ship no depth frames)."""
    pix, z = project_points(coord, k_matrix, rt_matrix)
    h, w = shape
    depth = np.full((h, w), np.inf, np.float32)
    ok = (
        (pix[:, 0] >= 0) & (pix[:, 1] >= 0)
        & (pix[:, 0] < w) & (pix[:, 1] < h)
        & (z > 0) & np.isfinite(pix).all(1)
    )
    uv = pix[ok].astype(np.int64)
    zz = z[ok]
    # keep the nearest point per pixel
    order = np.argsort(-zz)  # far first so near overwrites
    depth[uv[order, 1], uv[order, 0]] = zz[order]
    depth[~np.isfinite(depth)] = 0.0
    return depth
