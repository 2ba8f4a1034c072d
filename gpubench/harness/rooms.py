"""Synthetic indoor rooms from a seed, and the room mix a traffic file names.

The geometry is a copy of the port's smoke script's ``make_room``: a shell
(floor, ceiling, four walls with a door, a window and a board), a beam, a
column, box furniture placed at fractions of the room's size, and clutter,
each surface a jittered grid of points at ``spacing``; S3DIS' 13 classes
and colours. ScanNet rooms carry ScanNet's 20 classes and unit normals. The
normals are those of the surface each point was drawn on (the clutter's are
drawn at random), facing the room's centre, instead of a neighbourhood fit,
which took seconds a room.

The mix (``room_sizes``) fixes every room's kind and size from the traffic
file alone: the j-th room of a kind takes fixed quantiles of that kind's
size ranges. The seed changes only the draws inside a room (jitter,
clutter, colours), so every seed offers the same work to within the
clutter's and the crops' spread.
"""

from __future__ import annotations

import os

import numpy as np

# class id -> base colour (S3DIS' 13 classes)
COLORS = np.array([
    [200, 200, 200], [140, 120, 100], [220, 210, 190], [120, 100, 80],
    [180, 180, 170], [150, 190, 230], [130, 90, 60], [160, 110, 70],
    [60, 60, 140], [120, 40, 40], [90, 70, 50], [30, 80, 40], [110, 110, 110],
], np.float32)
# ScanNet's 20 classes for the room's 13 (S3DIS order): ceiling and beam
# unlabelled (-1), a column is wall, a board a picture, clutter
# otherfurniture
SCANNET20 = np.array([-1, 1, 0, -1, 0, 8, 7, 6, 4, 5, 9, 10, 19], np.int64)


def _plane(rng, origin, u, v, spacing):
    """(points, unit normal) of a jittered grid on origin + [0,1]u + [0,1]v."""
    origin, u, v = (np.asarray(x, np.float64) for x in (origin, u, v))
    nu = max(int(np.linalg.norm(u) / spacing), 1)
    nv = max(int(np.linalg.norm(v) / spacing), 1)
    a, b = np.meshgrid((np.arange(nu) + 0.5) / nu, (np.arange(nv) + 0.5) / nv)
    pts = origin + a.reshape(-1, 1) * u + b.reshape(-1, 1) * v
    n = np.cross(u, v)
    n = n / max(np.linalg.norm(n), 1e-12)
    return (pts + rng.uniform(-0.1, 0.1, pts.shape) * spacing,
            np.broadcast_to(n, pts.shape))


def _box(rng, lo, hi, spacing):
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    ex, ey, ez = np.diag(hi - lo)
    faces = [(lo, ex, ey), (lo + ez, ex, ey), (lo, ex, ez), (lo + ey, ex, ez),
             (lo, ey, ez), (lo + ex, ey, ez)]
    parts = [_plane(rng, o, u, v, spacing) for o, u, v in faces]
    return (np.concatenate([p for p, _ in parts]),
            np.concatenate([n for _, n in parts]))


def make_room(seed, size, spacing):
    """One room: coord (n, 3) f32, color (n, 3) in 0..255, normal (n, 3)
    unit, label (n,) in 0..12, instance (n,)."""
    rng = np.random.default_rng(seed)
    X, Y, Z = size
    parts = []

    def add(points_normals, label):
        p, n = points_normals
        parts.append((p, n, np.full(len(p), label, np.int64)))

    def box(lo, hi, label):  # lo / hi as fractions of the room
        add(_box(rng, np.multiply(lo, size), np.multiply(hi, size), spacing),
            label)

    add(_plane(rng, (0, 0, 0), (X, 0, 0), (0, Y, 0), spacing), 1)  # floor
    add(_plane(rng, (0, 0, Z), (X, 0, 0), (0, Y, 0), spacing), 0)  # ceiling
    walls = [_plane(rng, (0, 0, 0), (X, 0, 0), (0, 0, Z), spacing),
             _plane(rng, (0, Y, 0), (X, 0, 0), (0, 0, Z), spacing),
             _plane(rng, (0, 0, 0), (0, Y, 0), (0, 0, Z), spacing),
             _plane(rng, (X, 0, 0), (0, Y, 0), (0, 0, Z), spacing)]
    wp = np.concatenate([p for p, _ in walls])
    wl = np.full(len(wp), 2, np.int64)
    x, y, z = (wp / np.asarray(size)).T
    eps = 1e-4
    wl[(y < eps) & (x > 0.15) & (x < 0.33) & (z < 0.77)] = 6  # door
    wl[(y > 1 - eps) & (x > 0.4) & (x < 0.7) & (z > 0.35) & (z < 0.77)] = 5
    wl[(x < eps) & (y > 0.3) & (y < 0.7) & (z > 0.38) & (z < 0.77)] = 11
    parts.append((wp, np.concatenate([n for _, n in walls]), wl))
    box((0, 0.5, 0.89), (1, 0.56, 1), 3)  # beam
    box((0.92, 0.9, 0), (1, 1, 1), 4)  # column
    box((0.3, 0.3, 0.27), (0.63, 0.52, 0.29), 7)  # table
    box((0.17, 0.3, 0), (0.27, 0.41, 0.35), 8)  # chairs
    box((0.68, 0.35, 0), (0.77, 0.46, 0.35), 8)
    box((0.01, 0.01, 0), (0.39, 0.22, 0.31), 9)  # sofa
    box((0.75, 0.01, 0), (0.99, 0.11, 0.77), 10)  # bookcase
    n_clutter = int(0.01 * X * Y * Z / spacing**2)
    clutter = rng.uniform((0.1 * X, 0.1 * Y, 0), (0.9 * X, 0.9 * Y, 0.6 * Z),
                          (n_clutter, 3))
    add((clutter, rng.normal(size=(n_clutter, 3))), 12)

    coord = np.concatenate([p for p, _, _ in parts]).astype(np.float32)
    normal = np.concatenate([n for _, n, _ in parts])
    normal = normal / np.maximum(np.linalg.norm(normal, axis=1,
                                                keepdims=True), 1e-12)
    flip = np.einsum("ni,ni->n", normal, coord.mean(0) - coord) < 0
    normal[flip] = -normal[flip]
    label = np.concatenate([lab for _, _, lab in parts])
    color = np.clip(COLORS[label] + rng.normal(0, 12, (len(label), 3)), 0, 255)
    instance = np.repeat(np.arange(len(parts)), [len(p) for p, _, _ in parts])
    return dict(coord=coord, color=color.astype(np.float32),
                normal=normal.astype(np.float32), label=label,
                instance=instance)


def room_sizes(mix):
    """[(kind, (X, Y, Z))] of the ``mix["count"]`` rooms. Room i is of the
    first kind in ``mix["every"]`` ({kind: n}) with i % n == n - 1, else of
    ``mix["default"]``; the j-th of m rooms of a kind takes, in each
    dimension d, the quantile ((j * step_d + offset_d) % m + 0.5) / m of
    that kind's range ``mix["sizes"][kind][d]``."""
    count = mix["count"]
    kinds = []
    for i in range(count):
        kind = mix["default"]
        for k, n in mix["every"].items():
            if i % n == n - 1:
                kind = k
                break
        kinds.append(kind)
    out, seen = [], {}
    steps = ((1, 0), (7, 3), (3, 1))
    for kind in kinds:
        j = seen[kind] = seen.get(kind, -1) + 1
        m = kinds.count(kind)
        dims = []
        for (lo, hi), (step, off) in zip(mix["sizes"][kind], steps):
            q = ((j * step + off) % m + 0.5) / m
            dims.append(round(lo + q * (hi - lo), 4))
        out.append((kind, tuple(dims)))
    return out


def room_seeds(seed, count):
    """One generator seed a room, from the run's seed."""
    return np.random.SeedSequence([seed, 1]).generate_state(count).tolist()


def write_rooms(root, traffic, seed):
    """Write the traffic's rooms under ``root`` in the layout of its
    dataset; returns (the dataset root, [raw point count of each room])."""
    mix = traffic["rooms"]
    fmt = mix["format"]
    counts = []
    for i, ((kind, size), rs) in enumerate(zip(
            room_sizes(mix), room_seeds(seed, mix["count"]))):
        room = make_room(rs, size, mix["spacing"])
        counts.append(len(room["coord"]))
        if fmt == "s3dis":
            area = mix["areas"][i % len(mix["areas"])]
            d = os.path.join(root, area)
            os.makedirs(d, exist_ok=True)
            np.savez(os.path.join(d, f"{kind}_{i}.npz"), coord=room["coord"],
                     color=room["color"],
                     semantic_gt=room["label"].reshape(-1, 1),
                     instance_gt=room["instance"].reshape(-1, 1))
        elif fmt == "scannet":
            import torch

            d = os.path.join(root, mix["split"])
            os.makedirs(d, exist_ok=True)
            torch.save(dict(coord=room["coord"], color=room["color"],
                            normal=room["normal"],
                            semantic_gt20=SCANNET20[room["label"]],
                            instance_gt=room["instance"]),
                       os.path.join(d, f"scene{i:04d}_00.pth"))
        else:
            raise ValueError(f"unknown room format {fmt!r}")
    return root, counts
