"""Host-side point-cloud transforms (port of the whole of
ao_tpu/datasets/transform.py), with the same semantics (FNV-1a voxel
hashing, train and test GridSample modes, random sphere crops, dropout,
rotations, elastic distortion, the LiDAR range clip; ScanNet's
limited-annotation
``sampled_index`` kept through dropout and grid sampling). Arrays
stay numpy until ``collate_fn``; randomness comes from a
``torch.Generator`` (the default one unless a transform is given its own).
"""

from __future__ import annotations

import copy
import numbers
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
    (e.g. feat_keys=("coord", "color") -> data["feat"]). An offset whose
    source key the sample lacks is left out: a pair's views carry
    ``view1_coord`` / ``view2_coord`` and no ``coord``, where the JAX
    package's Collect raises (ROADMAP.md section 3)."""

    def __init__(self, keys, offset_keys_dict=None, **kwargs):
        self.keys = (keys,) if isinstance(keys, str) else tuple(keys)
        self.offset_keys = offset_keys_dict or dict(offset="coord")
        self.concat_groups = {
            name.replace("_keys", ""): tuple(v) for name, v in kwargs.items()
        }

    def __call__(self, data_dict):
        out = {k: data_dict[k] for k in self.keys}
        for name, src in self.offset_keys.items():
            if src in data_dict:
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
class ToArray(ToTensor):
    pass


@TRANSFORMS.register_module()
class NormalizeColor:
    def __call__(self, data_dict):
        if "color" in data_dict:
            data_dict["color"] = data_dict["color"] / 127.5 - 1
        return data_dict


@TRANSFORMS.register_module()
class NormalizeCoord:
    """Centre the cloud on its mean and scale it into the unit sphere."""

    def __call__(self, data_dict):
        if "coord" in data_dict:
            coord = data_dict["coord"] - np.mean(data_dict["coord"], axis=0)
            m = np.max(np.sqrt(np.sum(coord**2, axis=1)))
            data_dict["coord"] = coord / m
        return data_dict


@TRANSFORMS.register_module()
class PositiveShift:
    def __call__(self, data_dict):
        if "coord" in data_dict:
            data_dict["coord"] = data_dict["coord"] - np.min(
                data_dict["coord"], axis=0)
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
class RandomShift:
    """Shift the cloud by one uniform draw per axis from ``shift``'s
    (lo, hi) ranges."""

    def __init__(self, shift=((-0.2, 0.2), (-0.2, 0.2), (0, 0)),
                 generator: Optional[torch.Generator] = None):
        self.shift = shift
        self.generator = generator

    def __call__(self, data_dict):
        if "coord" in data_dict:
            offsets = np.array([_uniform(lo, hi, 1, self.generator)[0]
                                for lo, hi in self.shift])
            data_dict["coord"] = data_dict["coord"] + offsets
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
class ClipGaussianJitter:
    """Jitter by ``scalar`` x a standard normal clipped to its 1.96
    quantile; the jitter is kept under ``jitter`` with ``store_jitter``."""

    def __init__(self, scalar=0.02, store_jitter=False,
                 generator: Optional[torch.Generator] = None):
        self.scalar = scalar
        self.quantile = 1.96
        self.store_jitter = store_jitter
        self.generator = generator

    def __call__(self, data_dict):
        if "coord" in data_dict:
            n = data_dict["coord"].shape[0]
            jitter = self.scalar * np.clip(
                _normal((n, 3), self.generator) / self.quantile, -1, 1)
            data_dict["coord"] = data_dict["coord"] + jitter
            if self.store_jitter:
                data_dict["jitter"] = jitter
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
    or the middle point (mode "center") when the cloud has more. Mode
    "all" returns a list of crops that together cover every point
    (reference transform.py:899-998): each centred on the point of least
    accumulated weight (random weights of 1e-3 at most to start), whose
    members then gain (1 - d2 / max d2)^2; every crop carries ``index``
    (the original rows) and ``weight`` (its d2); a cloud within
    ``point_max`` is one crop of zero weights."""

    def __init__(self, point_max=80000, sample_rate=None, mode="random",
                 generator: Optional[torch.Generator] = None):
        if mode not in ("random", "center", "all"):
            raise ValueError(f"SphereCrop: unknown mode {mode!r}")
        self.point_max = point_max
        self.sample_rate = sample_rate
        self.mode = mode
        self.generator = generator

    def __call__(self, data_dict):
        n = data_dict["coord"].shape[0]
        point_max = (int(self.sample_rate * n) if self.sample_rate is not None
                     else self.point_max)
        if self.mode == "all":
            return self._all(data_dict, n, point_max)
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


    def _all(self, data_dict, n, point_max):
        if "index" not in data_dict:
            data_dict["index"] = np.arange(n)
        if n <= point_max:
            part = dict(data_dict)
            part["weight"] = np.zeros(n)
            return [part]
        coord = data_dict["coord"]
        coord_p = _uniform(0.0, 1.0, n, self.generator) * 1e-3
        covered = np.array([])
        parts = []
        while covered.size != data_dict["index"].shape[0]:
            dist2 = np.sum((coord - coord[np.argmin(coord_p)]) ** 2, 1)
            idx_crop = np.argsort(dist2)[:point_max]
            part = {k: data_dict[k][idx_crop] for k in POINT_KEYS
                    if isinstance(data_dict.get(k), np.ndarray)
                    and data_dict[k].shape[:1] == (n,)}
            part["weight"] = dist2[idx_crop]
            parts.append(part)
            coord_p[idx_crop] += np.square(1 - part["weight"] / np.max(part["weight"]))
            covered = np.unique(np.concatenate((covered, part["index"])))
        return parts


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


def rgb_to_grayscale(color, num_output_channels=1):
    """ITU-R 601-2 luma of RGB rows, one channel or repeated to three."""
    if color.shape[-1] < 3:
        raise TypeError("need >=3 color channels")
    if num_output_channels not in (1, 3):
        raise ValueError("num_output_channels must be 1 or 3")
    gray = (
        0.2989 * color[..., 0] + 0.587 * color[..., 1] + 0.114 * color[..., 2]
    ).astype(color.dtype)[..., None]
    if num_output_channels == 3:
        gray = np.broadcast_to(gray, color.shape)
    return gray


def _rgb_to_hsv(rgb):
    """RGB in [0, 1] to (h, s, v); hue from the first maximal channel."""
    v = rgb.max(-1)
    c = v - rgb.min(-1)
    s = np.where(v > 0, c / np.where(v > 0, v, 1.0), 0.0)
    safe_c = np.where(c > 0, c, 1.0)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    hue_by_dom = np.stack([np.mod((g - b) / safe_c, 6.0),
                           (b - r) / safe_c + 2.0,
                           (r - g) / safe_c + 4.0], axis=0)
    h = np.take_along_axis(hue_by_dom, rgb.argmax(-1)[None], axis=0)[0] / 6.0
    return np.where(c > 0, h, 0.0), s, v


def _hsv_to_rgb(h, s, v):
    """HSV in [0, 1] to RGB: channel_n = v - v s clip(min(k, 4 - k), 0, 1),
    k = (n + 6 h) mod 6, n = 5, 3, 1."""

    def channel(n):
        k = np.mod(n + h * 6.0, 6.0)
        return v - v * s * np.clip(np.minimum(k, 4.0 - k), 0.0, 1.0)

    return np.stack([channel(5.0), channel(3.0), channel(1.0)], axis=-1)


@TRANSFORMS.register_module()
class RandomColorJitter:
    """Brightness, contrast, saturation and hue jitter in a random order,
    each applied with probability ``p`` (torchvision's semantics). The
    draws: the order (a permutation of 4), one factor per enabled
    adjustment, then one uniform per adjustment in that order."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0, p=0.95,
                 generator: Optional[torch.Generator] = None):
        self.brightness = self._check(brightness, "brightness")
        self.contrast = self._check(contrast, "contrast")
        self.saturation = self._check(saturation, "saturation")
        self.hue = self._check(hue, "hue", center=0, bound=(-0.5, 0.5),
                               clip_first_on_zero=False)
        self.p = p
        self.generator = generator

    @staticmethod
    def _check(value, name, center=1, bound=(0, float("inf")),
               clip_first_on_zero=True):
        """A jitter strength as a (lo, hi) sampling range, or None when it
        is degenerate (no-op)."""
        if isinstance(value, numbers.Number):
            if value < 0:
                raise ValueError(f"{name} must be non-negative")
            lo, hi = center - float(value), center + float(value)
            if clip_first_on_zero:
                lo = max(lo, 0.0)
        elif isinstance(value, (tuple, list)) and len(value) == 2:
            lo, hi = float(value[0]), float(value[1])
            if not bound[0] <= lo <= hi <= bound[1]:
                raise ValueError(f"{name} out of bounds {bound}")
        else:
            raise TypeError(f"{name} must be number or pair")
        return None if lo == hi == center else (lo, hi)

    @staticmethod
    def _blend(c1, c2, ratio):
        return (float(ratio) * c1 + (1.0 - float(ratio)) * c2).clip(
            0, 255).astype(c1.dtype)

    def _draw(self, rng):
        return None if rng is None else _uniform(rng[0], rng[1], 1,
                                                 self.generator)[0]

    def __call__(self, data_dict):
        if "color" not in data_dict:
            return data_dict
        order = torch.randperm(4, generator=self.generator).tolist()
        b, c, s, h = (self._draw(r) for r in (self.brightness, self.contrast,
                                              self.saturation, self.hue))
        for fn_id in order:
            factor = (b, c, s, h)[fn_id]
            if factor is None or _uniform(0.0, 1.0, 1, self.generator)[0] >= self.p:
                continue
            color = data_dict["color"]
            if fn_id == 0:
                color = self._blend(color, np.zeros_like(color), factor)
            elif fn_id == 1:
                color = self._blend(color, np.mean(rgb_to_grayscale(color)), factor)
            elif fn_id == 2:
                color = self._blend(color, rgb_to_grayscale(color), factor)
            else:
                hh, ss, vv = _rgb_to_hsv(color / 255.0)
                color = (_hsv_to_rgb(np.mod(hh + factor, 1.0), ss, vv)
                         * 255.0).astype(color.dtype)
            data_dict["color"] = color
        return data_dict


@TRANSFORMS.register_module()
class RandomColorGrayScale:
    def __init__(self, p, generator: Optional[torch.Generator] = None):
        self.p = p
        self.generator = generator

    def __call__(self, data_dict):
        if "color" in data_dict and _uniform(0.0, 1.0, 1, self.generator)[0] < self.p:
            data_dict["color"] = rgb_to_grayscale(data_dict["color"], 3)
        return data_dict


@TRANSFORMS.register_module()
class HueSaturationTranslation:
    """One hue offset in [-hue_max, hue_max] and one saturation ratio in
    [1 - saturation_max, 1 + saturation_max] per scene, in HSV."""

    def __init__(self, hue_max=0.5, saturation_max=0.2,
                 generator: Optional[torch.Generator] = None):
        self.hue_max = hue_max
        self.saturation_max = saturation_max
        self.generator = generator

    def __call__(self, data_dict):
        if "color" in data_dict:
            h, s, v = _rgb_to_hsv(data_dict["color"][:, :3] / 255.0)
            dh = _uniform(-self.hue_max, self.hue_max, 1, self.generator)[0]
            ds = _uniform(-self.saturation_max, self.saturation_max, 1,
                          self.generator)[0]
            h = np.mod(h + dh, 1.0)
            s = np.clip(s * (1 + ds), 0.0, 1.0)
            data_dict["color"][:, :3] = np.clip(_hsv_to_rgb(h, s, v) * 255.0, 0, 255)
        return data_dict


@TRANSFORMS.register_module()
class RandomColorDrop:
    def __init__(self, p=0.2, color_augment=0.0,
                 generator: Optional[torch.Generator] = None):
        self.p = p
        self.color_augment = color_augment
        self.generator = generator

    def __call__(self, data_dict):
        if "color" in data_dict and _uniform(0.0, 1.0, 1, self.generator)[0] < self.p:
            data_dict["color"] = data_dict["color"] * self.color_augment
        return data_dict


@TRANSFORMS.register_module()
class ShufflePoint:
    def __init__(self, generator: Optional[torch.Generator] = None):
        self.generator = generator

    def __call__(self, data_dict):
        n = data_dict["coord"].shape[0]
        idx = torch.randperm(n, generator=self.generator).numpy()
        return index_points(data_dict, idx)


@TRANSFORMS.register_module()
class CropBoundary:
    """Drop the points of classes 0 and 1 (S3DIS' ceiling and floor)."""

    def __call__(self, data_dict):
        segment = data_dict["segment"].flatten()
        return index_points(data_dict, (segment != 0) & (segment != 1))


@TRANSFORMS.register_module()
class ContrastiveViewsGenerator:
    """Two augmented copies of ``view_keys`` as ``view1_<key>`` and
    ``view2_<key>``: the view transforms run on view 1, then on view 2,
    drawing from ``generator`` (given to every view transform that draws)."""

    def __init__(self, view_keys=("coord", "color", "normal", "origin_coord"),
                 view_trans_cfg=None,
                 generator: Optional[torch.Generator] = None):
        self.view_keys = view_keys
        self.view_trans = Compose(view_trans_cfg)
        for t in self.view_trans.transforms:
            if hasattr(t, "generator"):
                t.generator = generator

    def __call__(self, data_dict):
        for prefix in ("view1_", "view2_"):
            view = self.view_trans({k: data_dict[k].copy() for k in self.view_keys})
            for k, v in view.items():
                data_dict[prefix + k] = v
        return data_dict


@TRANSFORMS.register_module()
class InstanceParser:
    """Instance ids renumbered 0.. over the points whose segment is not in
    ``segment_ignore_index`` (the others ``instance_ignore_index``), each
    point's instance centre (the mean of its instance's coords; ignored
    points ``instance_ignore_index`` in all three) and each instance's
    bounding box (min, max)."""

    def __init__(self, segment_ignore_index=(-1, 0, 1), instance_ignore_index=-1):
        self.segment_ignore_index = segment_ignore_index
        self.instance_ignore_index = instance_ignore_index

    def __call__(self, data_dict):
        coord = data_dict["coord"]
        segment = data_dict["segment"]
        instance = data_dict["instance"].copy()
        mask = ~np.isin(segment, self.segment_ignore_index)
        instance[~mask] = self.instance_ignore_index
        unique, inverse = np.unique(instance[mask], return_inverse=True)
        instance_num = len(unique)
        instance[mask] = inverse
        center = np.ones((coord.shape[0], 3)) * self.instance_ignore_index
        bbox = np.ones((instance_num, 6)) * self.instance_ignore_index
        for iid in range(instance_num):
            m = instance == iid
            pts = coord[m]
            center[m] = pts.mean(0)
            bbox[iid] = np.concatenate([pts.min(0), pts.max(0)])
        data_dict["instance"] = instance
        data_dict["instance_center"] = center
        data_dict["bbox"] = bbox
        return data_dict


class Compose:
    def __init__(self, cfg=None):
        self.cfg = cfg if cfg is not None else []
        self.transforms = [TRANSFORMS.build(dict(t)) for t in self.cfg]

    def __call__(self, data_dict):
        for t in self.transforms:
            data_dict = t(data_dict)
        return data_dict
