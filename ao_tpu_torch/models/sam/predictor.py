"""SamPredictor on the port's SAM (port of ao_tpu/models/sam/predictor.py).

Mirrors the ``segment_anything.SamPredictor`` contract the reference uses
(reference: engines/train_sam_real.py:167-174 ``set_image`` /
``predict_torch`` on cached embeddings, utils/my_run_sam_final.py:95-98):
``set_image`` embeds a uint8 RGB image once; ``predict`` prompts with
point batches and returns boolean masks at original resolution;
``predict_batch`` decodes F frames x P prompts in one decoder call.
Embeddings are channel-last (1, s, s, C) tensors, cached on disk by PP2S
as ao_tpu caches them; ``set_features`` / ``predict_batch`` also take
channel-first (official torch) caches.

Resizes follow ``jax.image.resize(..., "linear")``: half-pixel centres,
and antialiased when shrinking (``F.interpolate(mode="bilinear",
align_corners=False, antialias=True)``); the model runs in f32 on
``device``. Without a ``state_dict`` the model is built on the device
from seed 0 (``modeling.build_sam``), as ao_tpu's from PRNGKey(0).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .modeling import SamConfig, SamModel, build_sam

_PIXEL_MEAN = (123.675, 116.28, 103.53)
_PIXEL_STD = (58.395, 57.12, 57.375)


def resize_linear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(..., H, W) -> (..., h, w) as ``jax.image.resize(method="linear")``:
    bilinear with half-pixel centres, antialiased where it shrinks."""
    lead = x.shape[:-2]
    x = x.reshape((-1, 1) + tuple(x.shape[-2:]))
    shrink = size[0] < x.shape[-2] or size[1] < x.shape[-1]
    x = F.interpolate(x, size=tuple(size), mode="bilinear",
                      align_corners=False, antialias=shrink)
    return x.reshape(lead + tuple(size))


class SamPredictor:
    def __init__(self, config: Optional[SamConfig] = None, state_dict=None,
                 device="cuda"):
        self.config = config or SamConfig.vit_h()
        self.device = torch.device(device)
        self._state_dict = state_dict
        self.model: Optional[SamModel] = None
        self._features = None
        self._orig_size = None
        self._input_size = None

    def _ensure_model(self) -> SamModel:
        """No-checkpoint mode (no SAM weights ship with the repo):
        deterministic random weights from seed 0, built on the device, so
        offline embeddings and in-loop decodes agree."""
        if self.model is None:
            model = build_sam(self.config, 0, self.device)
            if self._state_dict is not None:
                # the mask-prompt downscaling may be absent (flax creates it
                # only when a mask prompt is given; no caller gives one)
                missing, unexpected = model.load_state_dict(
                    self._state_dict, strict=False)
                bad = unexpected + [k for k in missing if not k.startswith(
                    "prompt_encoder.mask_downscaling.")]
                if bad:
                    raise KeyError(f"SAM state_dict does not fit: {bad}")
                self._state_dict = None
            self.model = model
        return self.model

    # -- image path --
    def _preprocess(self, image: np.ndarray):
        """uint8 RGB (H, W, 3) -> normalised padded (1, 3, S, S)."""
        S = self.config.vision.image_size
        h, w = image.shape[:2]
        scale = S / max(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        img = torch.as_tensor(np.array(image, np.float32),
                              device=self.device).permute(2, 0, 1)
        img = resize_linear(img, (nh, nw))
        mean = torch.tensor(_PIXEL_MEAN, device=self.device)[:, None, None]
        std = torch.tensor(_PIXEL_STD, device=self.device)[:, None, None]
        img = F.pad((img - mean) / std, (0, S - nw, 0, S - nh))
        return img[None], (h, w), (nh, nw)

    @torch.no_grad()
    def set_image(self, image: np.ndarray):
        """Embed one uint8 RGB image; returns its (1, s, s, C) features."""
        model = self._ensure_model()
        x, self._orig_size, self._input_size = self._preprocess(image)
        self._features = model.get_image_embeddings(x)
        return self._features

    @property
    def features(self):
        return self._features

    def _features_nhwc(self, features) -> torch.Tensor:
        f = torch.as_tensor(features, dtype=torch.float32, device=self.device)
        if f.dim() == 3:
            f = f[None]
        # official torch caches are channel-first (1, C, 64, 64)
        if f.shape[1] == self.config.vision.output_channels:
            f = f.permute(0, 2, 3, 1)
        return f.contiguous()

    def _set_sizes(self, orig_size):
        self._orig_size = tuple(orig_size)
        S = self.config.vision.image_size
        scale = S / max(orig_size)
        self._input_size = (int(round(orig_size[0] * scale)),
                            int(round(orig_size[1] * scale)))

    def set_features(self, features, orig_size: Tuple[int, int]):
        """Restore cached embeddings (the REAL loop's disk cache path)."""
        self._features = self._features_nhwc(features)
        self._set_sizes(orig_size)

    def _transform_points(self, coords: np.ndarray) -> np.ndarray:
        """Original-image (x, y) -> model input coords."""
        h, w = self._orig_size
        nh, nw = self._input_size
        coords = np.asarray(coords, np.float32).copy()
        coords[..., 0] *= nw / w
        coords[..., 1] *= nh / h
        return coords

    def _decode(self, features, pts: np.ndarray, lbl: np.ndarray):
        model = self._ensure_model()
        return model.predict_masks(
            features, torch.as_tensor(pts, device=self.device),
            torch.as_tensor(lbl, dtype=torch.int64, device=self.device))

    @torch.no_grad()
    def predict(
        self,
        point_coords: np.ndarray,  # (P, n, 2) or (n, 2), original (x, y)
        point_labels: np.ndarray,  # (P, n) or (n,)
        multimask_output: bool = True,
        return_logits: bool = False,
    ):
        """Returns (masks (P, m, H, W), iou (P, m), low_res (P, m, s4, s4)),
        numpy."""
        assert self._features is not None, "call set_image/set_features first"
        point_coords = np.asarray(point_coords, np.float32)
        point_labels = np.asarray(point_labels, np.int32)
        if point_coords.ndim == 2:
            point_coords = point_coords[None]
            point_labels = point_labels[None]
        pts = self._transform_points(point_coords)[None]  # (1, P, n, 2)
        low_res, iou = self._decode(self._features, pts, point_labels[None])
        masks = self._postprocess(low_res[0])  # (P, m, H, W)
        if not return_logits:
            masks = masks > 0.0
        return (masks.cpu().numpy(), iou[0].cpu().numpy(),
                low_res[0].cpu().numpy())

    @torch.no_grad()
    def predict_batch(
        self,
        features,  # (F, h, w, C) image embeddings for F frames
        point_coords,  # (F, P, n, 2) original-resolution (x, y)
        point_labels,  # (F, P, n)
        orig_size: Tuple[int, int],
        mask_index: Optional[int] = None,
    ):
        """Decode prompts for F frames in ONE decoder call (the REAL
        refinement loop's path; the reference loops frame by frame,
        train_sam_real.py:402-450). Only ``mask_index``'s channel is
        upsampled, one frame at a time.

        Returns (masks (F, P, m, H, W) bool, iou (F, P, m)), numpy."""
        features = self._features_nhwc(features)
        self._set_sizes(orig_size)
        pts = self._transform_points(np.asarray(point_coords, np.float32))
        low_res, iou = self._decode(
            features, pts, np.asarray(point_labels, np.int32))
        if mask_index is not None:
            low_res = low_res[:, :, mask_index: mask_index + 1]
        masks = np.stack(
            [(self._postprocess(lr) > 0.0).cpu().numpy() for lr in low_res])
        return masks, iou.cpu().numpy()

    def _postprocess(self, low_res_masks):
        """(P, m, s4, s4) logits -> original-resolution (P, m, H, W)."""
        S = self.config.vision.image_size
        nh, nw = self._input_size
        x = resize_linear(low_res_masks, (S, S))[..., :nh, :nw]
        return resize_linear(x, self._orig_size)
