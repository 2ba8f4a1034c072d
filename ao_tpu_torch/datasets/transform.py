"""Host-side point-cloud transforms of the S3DIS, ScanNet, SemanticKITTI
and nuScenes train and test paths.

Port of the transforms of ao_tpu/datasets/transform.py that the PT-v2
configs of those datasets name, with the same semantics (FNV-1a voxel
hashing, train and test GridSample modes, random sphere crops, dropout,
rotations, elastic distortion, the LiDAR range clip; ScanNet's
limited-annotation
``sampled_index`` kept through dropout and grid sampling). Arrays
stay numpy until ``collate_fn``; randomness comes from a
``torch.Generator`` (the default one unless a transform is given its own).
"""

from __future__ import annotations

import copy
from collections.abc import Mapping, Sequence
from typing import Optional

import numpy as np
import torch

from ..utils.registry import Registry

TRANSFORMS = Registry("transforms")


def _uniform(lo, hi, n, generator):
    # float64, so that a degenerate range [a, a] gives exactly a, as
    # numpy's uniform does
    u = torch.rand(n, generator=generator, dtype=torch.float64).numpy()
    return lo + (hi - lo) * u


def _normal(shape, generator):
    return torch.randn(shape, generator=generator, dtype=torch.float64).numpy()


# keys that hold one row per point and are indexed together
POINT_KEYS = (
    "coord", "origin_coord", "discrete_coord", "color", "normal", "strength",
    "segment", "origin_segment", "instance", "displacement", "weight",
    "index",
)


def index_points(data_dict: dict, idx) -> dict:
    """Apply an index to every per-point array present in data_dict."""
    n = data_dict["coord"].shape[0]
    for key in POINT_KEYS:
        v = data_dict.get(key)
        if isinstance(v, np.ndarray) and v.shape[:1] == (n,):
            data_dict[key] = v[idx]
    return data_dict


@TRANSFORMS.register_module()
class Collect:
    """Select keys and concatenate ``*_keys`` groups into single arrays
    (e.g. feat_keys=("coord", "color") -> data["feat"])."""

    def __init__(self, keys, offset_keys_dict=None, **kwargs):
        self.keys = (keys,) if isinstance(keys, str) else tuple(keys)
        self.offset_keys = offset_keys_dict or dict(offset="coord")
        self.concat_groups = {
            name.replace("_keys", ""): tuple(v) for name, v in kwargs.items()
        }

    def __call__(self, data_dict):
        out = {k: data_dict[k] for k in self.keys}
        for name, src in self.offset_keys.items():
            out[name] = np.array([data_dict[src].shape[0]], dtype=np.int64)
        for name, keys in self.concat_groups.items():
            out[name] = np.concatenate(
                [np.asarray(data_dict[k], np.float32).reshape(
                    data_dict[k].shape[0], -1) for k in keys],
                axis=1,
            )
        return out


@TRANSFORMS.register_module()
class Copy:
    def __init__(self, keys_dict=None):
        self.keys_dict = keys_dict or dict(
            coord="origin_coord", segment="origin_segment"
        )

    def __call__(self, data_dict):
        for key, new_key in self.keys_dict.items():
            v = data_dict[key]
            data_dict[new_key] = (
                v.copy() if isinstance(v, np.ndarray) else copy.deepcopy(v)
            )
        return data_dict


@TRANSFORMS.register_module()
class ToTensor:
    """Canonicalise dtypes (int64 / float32); arrays stay numpy until
    collate. The name is kept for config compatibility."""

    def __call__(self, data):
        if isinstance(data, str):
            return data
        if isinstance(data, int):
            return np.array([data], dtype=np.int64)
        if isinstance(data, float):
            return np.array([data], dtype=np.float32)
        if isinstance(data, np.ndarray):
            if np.issubdtype(data.dtype, bool):
                return data
            if np.issubdtype(data.dtype, np.integer):
                return data.astype(np.int64)
            if np.issubdtype(data.dtype, np.floating):
                return data.astype(np.float32)
            return data
        if isinstance(data, Mapping):
            return {k: self(v) for k, v in data.items()}
        if isinstance(data, Sequence):
            return [self(v) for v in data]
        raise TypeError(f"type {type(data)} cannot be converted")


@TRANSFORMS.register_module()
class NormalizeColor:
    def __call__(self, data_dict):
        if "color" in data_dict:
            data_dict["color"] = data_dict["color"] / 127.5 - 1
        return data_dict


@TRANSFORMS.register_module()
class CenterShift:
    def __init__(self, apply_z=True):
        self.apply_z = apply_z

    def __call__(self, data_dict):
        if "coord" in data_dict:
            lo = data_dict["coord"].min(axis=0)
            hi = data_dict["coord"].max(axis=0)
            shift = np.array(
                [
                    (lo[0] + hi[0]) / 2,
                    (lo[1] + hi[1]) / 2,
                    lo[2] if self.apply_z else 0,
                ]
            )
            data_dict["coord"] = data_dict["coord"] - shift
        return data_dict


@TRANSFORMS.register_module()
class RandomScale:
    def __init__(self, scale=None, anisotropic=False,
                 generator: Optional[torch.Generator] = None):
        self.scale = scale or [0.95, 1.05]
        self.anisotropic = anisotropic
        self.generator = generator

    def __call__(self, data_dict):
        if "coord" in data_dict:
            scale = _uniform(self.scale[0], self.scale[1],
                             3 if self.anisotropic else 1, self.generator)
            data_dict["coord"] = data_dict["coord"] * scale
        return data_dict


@TRANSFORMS.register_module()
class RandomFlip:
    def __init__(self, p=0.5, generator: Optional[torch.Generator] = None):
        self.p = p
        self.generator = generator

    def __call__(self, data_dict):
        for axis in (0, 1):
            if _uniform(0.0, 1.0, 1, self.generator)[0] < self.p:
                if "coord" in data_dict:
                    data_dict["coord"][:, axis] = -data_dict["coord"][:, axis]
                if "normal" in data_dict:
                    data_dict["normal"][:, axis] = -data_dict["normal"][:, axis]
        return data_dict


@TRANSFORMS.register_module()
class RandomJitter:
    def __init__(self, sigma=0.01, clip=0.05,
                 generator: Optional[torch.Generator] = None):
        if clip <= 0:
            raise ValueError("RandomJitter: clip must be positive")
        self.sigma = sigma
        self.clip = clip
        self.generator = generator

    def __call__(self, data_dict):
        if "coord" in data_dict:
            n = data_dict["coord"].shape[0]
            jitter = np.clip(self.sigma * _normal((n, 3), self.generator),
                             -self.clip, self.clip)
            data_dict["coord"] = data_dict["coord"] + jitter
        return data_dict


@TRANSFORMS.register_module()
class ChromaticAutoContrast:
    def __init__(self, p=0.2, blend_factor=None,
                 generator: Optional[torch.Generator] = None):
        self.p = p
        self.blend_factor = blend_factor
        self.generator = generator

    def __call__(self, data_dict):
        if "color" in data_dict and _uniform(0.0, 1.0, 1, self.generator)[0] < self.p:
            color = data_dict["color"][:, :3]
            lo = color.min(0, keepdims=True)
            hi = color.max(0, keepdims=True)
            contrast = (color - lo) * (255 / np.maximum(hi - lo, 1e-12))
            blend = (_uniform(0.0, 1.0, 1, self.generator)[0]
                     if self.blend_factor is None else self.blend_factor)
            data_dict["color"][:, :3] = (1 - blend) * color + blend * contrast
        return data_dict


@TRANSFORMS.register_module()
class ChromaticTranslation:
    def __init__(self, p=0.95, ratio=0.05,
                 generator: Optional[torch.Generator] = None):
        self.p = p
        self.ratio = ratio
        self.generator = generator

    def __call__(self, data_dict):
        if "color" in data_dict and _uniform(0.0, 1.0, 1, self.generator)[0] < self.p:
            tr = (_uniform(0.0, 1.0, 3, self.generator)[None] - 0.5) * 255 * 2 * self.ratio
            data_dict["color"][:, :3] = np.clip(
                data_dict["color"][:, :3] + tr, 0, 255)
        return data_dict


@TRANSFORMS.register_module()
class ChromaticJitter:
    def __init__(self, p=0.95, std=0.005,
                 generator: Optional[torch.Generator] = None):
        self.p = p
        self.std = std
        self.generator = generator

    def __call__(self, data_dict):
        if "color" in data_dict and _uniform(0.0, 1.0, 1, self.generator)[0] < self.p:
            n = data_dict["color"].shape[0]
            noise = _normal((n, 3), self.generator) * self.std * 255
            data_dict["color"][:, :3] = np.clip(
                data_dict["color"][:, :3] + noise, 0, 255)
        return data_dict


@TRANSFORMS.register_module()
class PointClip:
    """Clip ``coord`` to the box ``point_cloud_range`` = (x_min, y_min,
    z_min, x_max, y_max, z_max): points outside move onto its faces."""

    def __init__(self, point_cloud_range=(-80, -80, -3, 80, 80, 1)):
        self.range = point_cloud_range

    def __call__(self, data_dict):
        if "coord" in data_dict:
            data_dict["coord"] = np.clip(
                data_dict["coord"], a_min=self.range[:3], a_max=self.range[3:])
        return data_dict


@TRANSFORMS.register_module()
class RandomDropout:
    """With probability ``dropout_application_ratio`` keep a random
    ``1 - dropout_ratio`` of the points (without replacement), and every
    point of ``sampled_index``, renumbered into the kept points."""

    def __init__(self, dropout_ratio=0.2, dropout_application_ratio=0.5,
                 generator: Optional[torch.Generator] = None):
        self.dropout_ratio = dropout_ratio
        self.dropout_application_ratio = dropout_application_ratio
        self.generator = generator

    def __call__(self, data_dict):
        if _uniform(0.0, 1.0, 1, self.generator)[0] < self.dropout_application_ratio:
            n = len(data_dict["coord"])
            m = int(n * (1 - self.dropout_ratio))
            idx = torch.randperm(n, generator=self.generator)[:m].numpy()
            if "sampled_index" in data_dict:
                idx = np.unique(np.append(idx, data_dict["sampled_index"]))
                keep = np.zeros(n, bool)
                keep[data_dict["sampled_index"]] = True
                data_dict["sampled_index"] = np.where(keep[idx])[0]
            index_points(data_dict, idx)
        return data_dict


def _rotation_matrix(angle: float, axis: str) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    if axis == "x":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    if axis == "y":
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    if axis == "z":
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    raise ValueError(f"rotation axis {axis!r}")


class _BaseRotate:
    """Rotate ``coord`` about ``center`` (the bounding box's centre when
    None) and ``normal`` by ``angle`` radians about ``axis``."""

    def _apply(self, data_dict, angle):
        rot = _rotation_matrix(angle, self.axis)
        if "coord" in data_dict:
            if self.center is None:
                center = (data_dict["coord"].min(0) + data_dict["coord"].max(0)) / 2
            else:
                center = np.asarray(self.center)
            data_dict["coord"] = (data_dict["coord"] - center) @ rot.T + center
        if "normal" in data_dict:
            data_dict["normal"] = data_dict["normal"] @ rot.T
        return data_dict


@TRANSFORMS.register_module()
class RandomRotate(_BaseRotate):
    """With probability ``p``, rotate by a uniform angle in ``angle`` x pi."""

    def __init__(self, angle=None, center=None, axis="z", always_apply=False,
                 p=0.5, generator: Optional[torch.Generator] = None):
        self.angle = [-1, 1] if angle is None else angle
        self.axis = axis
        self.center = center
        self.p = 1.0 if always_apply else p
        self.generator = generator

    def __call__(self, data_dict):
        if _uniform(0.0, 1.0, 1, self.generator)[0] > self.p:
            return data_dict
        angle = _uniform(self.angle[0], self.angle[1], 1, self.generator)[0]
        return self._apply(data_dict, angle * np.pi)


@TRANSFORMS.register_module()
class RandomRotateTargetAngle(_BaseRotate):
    """With probability ``p``, rotate by one of ``angle`` (x pi), drawn
    uniformly."""

    def __init__(self, angle=(1 / 2, 1, 3 / 2), center=None, axis="z",
                 always_apply=False, p=0.75,
                 generator: Optional[torch.Generator] = None):
        self.angle = angle
        self.axis = axis
        self.center = center
        self.p = 1.0 if always_apply else p
        self.generator = generator

    def __call__(self, data_dict):
        if _uniform(0.0, 1.0, 1, self.generator)[0] > self.p:
            return data_dict
        i = int(torch.randint(0, len(self.angle), (1,), generator=self.generator))
        return self._apply(data_dict, self.angle[i] * np.pi)


@TRANSFORMS.register_module()
class ElasticDistortion:
    """With probability 0.95, displace the points by a smooth random field
    for each (granularity, magnitude) of ``distortion_params``, in order:
    white noise on a grid of spacing ``granularity`` (one padding cell on
    every side), blurred twice by a 3-tap box filter per axis and sampled
    trilinearly at each point (scipy.ndimage, as ao_tpu)."""

    def __init__(self, distortion_params=None,
                 generator: Optional[torch.Generator] = None):
        self.distortion_params = ([[0.2, 0.4], [0.8, 1.6]]
                                  if distortion_params is None
                                  else distortion_params)
        self.generator = generator

    def elastic_distortion(self, coords, granularity, magnitude):
        from scipy import ndimage

        mins = coords.min(0)
        dims = ((coords.max(0) - mins) // granularity).astype(int) + 3
        field = _normal((*dims, 3), self.generator).astype(np.float32)
        for _ in range(2):
            field = ndimage.uniform_filter(field, size=(3, 3, 3, 1),
                                           mode="constant")
        gidx = ((coords - mins) / granularity + 1.0).T  # (3, N), past the pad
        disp = np.stack([ndimage.map_coordinates(field[..., c], gidx, order=1,
                                                 mode="constant")
                         for c in range(3)], axis=-1)
        return coords + disp * magnitude

    def __call__(self, data_dict):
        if "coord" in data_dict and self.distortion_params is not None:
            if _uniform(0.0, 1.0, 1, self.generator)[0] < 0.95:
                for granularity, magnitude in self.distortion_params:
                    data_dict["coord"] = self.elastic_distortion(
                        data_dict["coord"], granularity, magnitude)
        return data_dict


@TRANSFORMS.register_module()
class SphereCrop:
    """Keep the ``point_max`` points nearest a random point (mode "random")
    or the middle point (mode "center") when the cloud has more."""

    def __init__(self, point_max=80000, sample_rate=None, mode="random",
                 generator: Optional[torch.Generator] = None):
        if mode not in ("random", "center"):
            raise ValueError(f"SphereCrop: mode {mode!r} is not ported")
        self.point_max = point_max
        self.sample_rate = sample_rate
        self.mode = mode
        self.generator = generator

    def __call__(self, data_dict):
        n = data_dict["coord"].shape[0]
        point_max = (int(self.sample_rate * n) if self.sample_rate is not None
                     else self.point_max)
        if n > point_max:
            if self.mode == "random":
                i = int(torch.randint(0, n, (1,), generator=self.generator))
            else:
                i = n // 2
            center = data_dict["coord"][i]
            idx_crop = np.argsort(
                np.sum((data_dict["coord"] - center) ** 2, 1))[:point_max]
            index_points(data_dict, idx_crop)
        return data_dict


@TRANSFORMS.register_module()
class GridSample:
    """Voxel-hash grid sampling (reference: transform.py:770-896) with the
    FNV-1a hash the S3DIS configs name.

    train mode: keep one random point per voxel; test mode: emit
    ``count.max()`` complementary fragments that jointly cover every point
    (each with an ``index`` map back to the full scene). The hashing and
    per-voxel selection follow ao_tpu's GridSample exactly, so both
    packages voxelise a scene identically.
    """

    def __init__(
        self,
        grid_size=0.05,
        hash_type="fnv",
        mode="train",
        keys=("coord", "color", "normal", "segment"),
        return_discrete_coord=False,
        generator: Optional[torch.Generator] = None,
    ):
        if hash_type != "fnv" or mode not in ("train", "test"):
            raise ValueError(
                f"GridSample supports hash_type='fnv' and modes train / test, "
                f"got {hash_type!r}, {mode!r}")
        self.grid_size = grid_size
        self.mode = mode
        self.keys = keys
        self.return_discrete_coord = return_discrete_coord
        self.generator = generator

    def __call__(self, data_dict):
        scaled = data_dict["coord"] / np.array(self.grid_size)
        discrete = np.floor(scaled).astype(int)
        discrete = discrete - discrete.min(0)
        key = self.fnv_hash_vec(discrete)
        idx_sort = np.argsort(key)
        key_sorted = key[idx_sort]
        _, count = np.unique(key_sorted, return_counts=True)
        seg_starts = np.cumsum(np.insert(count, 0, 0)[:-1])

        if self.mode == "train":
            pick = torch.randint(
                0, int(count.max()), (count.size,), generator=self.generator
            ).numpy()
            idx_unique = idx_sort[seg_starts + pick % count]
            if "sampled_index" in data_dict:
                # limited annotations: the labelled points stay in the sample
                idx_unique = np.unique(
                    np.append(idx_unique, data_dict["sampled_index"]))
                keep = np.zeros_like(data_dict["segment"], bool)
                keep[data_dict["sampled_index"]] = True
                data_dict["sampled_index"] = np.where(keep[idx_unique])[0]
            if self.return_discrete_coord:
                data_dict["discrete_coord"] = discrete[idx_unique]
            for key_name in self.keys:
                data_dict[key_name] = data_dict[key_name][idx_unique]
            return data_dict

        fragments = []
        for i in range(count.max()):
            idx_part = idx_sort[seg_starts + i % count]
            part = dict(index=idx_part)
            if self.return_discrete_coord:
                part["discrete_coord"] = discrete[idx_part]
            for key_name, value in data_dict.items():
                part[key_name] = value[idx_part] if key_name in self.keys else value
            fragments.append(part)
        return fragments

    @staticmethod
    def fnv_hash_vec(arr):
        """FNV64-1A hash of integer coordinate rows."""
        arr = arr.copy().astype(np.uint64, copy=False)
        hashed = np.uint64(14695981039346656037) * np.ones(
            arr.shape[0], dtype=np.uint64
        )
        for j in range(arr.shape[1]):
            hashed *= np.uint64(1099511628211)
            hashed = np.bitwise_xor(hashed, arr[:, j])
        return hashed


class Compose:
    def __init__(self, cfg=None):
        self.cfg = cfg if cfg is not None else []
        self.transforms = [TRANSFORMS.build(dict(t)) for t in self.cfg]

    def __call__(self, data_dict):
        for t in self.transforms:
            data_dict = t(data_dict)
        return data_dict
