"""Oracle-SAM: GT-instance masks with a SAM-like error model (a copy of
ao_tpu/models/sam/oracle.py, numpy and scipy only).

This environment ships no SAM checkpoint (the reference assumes a
downloaded ``sam_vit_h`` at SAM_ckpt/, e.g. engines/train_sam_real.py's
predictor setup), so a randomly initialised SAM returns noise masks and
the AO loop degenerates (round-3 finding). The oracle replaces the
neural decoder with masks synthesised from per-frame GT *instance-id
maps*: prompting a pixel returns (a corruption of) the mask of the GT
instance under that pixel. This reproduces the statistical behaviour the
loop depends on — a real SAM prompted inside an object returns roughly
that object's mask, better for interior prompts, worse near boundaries —
so PP2S pseudo-labels land in the reference's starting-quality regime
(label mIoU ~0.3-0.5, reference train_sam_final.py:539-548) and REAL
refinement has a genuine signal: better-mined prompts earn better masks.

The id maps ride the existing embedding cache: PP2S stage 1 in oracle
mode rasterises each frame's instance ids (same splat z-buffer as the
rendered rgb/depth, pp2s/projection.py splat_raster) into
``embeddings/<area>/<room>/<frame>.npz`` under the usual ``features``
key, as an (H, W) int32 array. Everything downstream — the disk cache,
``set_features``, ``predict``, ``predict_batch`` — keeps the
SamPredictor contract (predictor.py), so PP2S stage 5 and the REAL
refinement loop run unchanged.

Error model, deterministic per (instance, prompt pixel):

* interiorness d = ring-probed distance from the prompt to the nearest
  pixel of a different instance; prompts with d >= ``d0`` are "good".
* with probability ``p_good = quality * clip(0.15 + 0.85 * d / d0)``
  the mask is the exact instance mask;
* otherwise it is corrupted: either BLEED (union with the neighbouring
  instance the prompt is closest to — SAM merging touching objects) or
  PARTIAL (the instance mask cut by a half-plane near the prompt — SAM
  under-segmenting from an off-centre prompt).
* the returned "predicted IoU" score is p_good plus small deterministic
  noise, so confidence ordering is informative, as with the real model.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["OracleSamPredictor"]

_RINGS = (1, 2, 3, 4, 6, 8, 11, 14, 18, 23)


def _clean_id_map(m: np.ndarray, size: int = 5) -> np.ndarray:
    """Majority-filter a splatted instance-id map.

    Sparse point splats interleave overlapping instances at pixel
    granularity (far points poke through gaps between near points) and
    leave holes. A real SAM operates on a dense image where each region
    reads as one object, so the oracle decodes from the local-majority
    map: every pixel takes the id with the highest density in its
    ``size`` x ``size`` window (holes fill from neighbours; pixels with
    no painted neighbour stay -1)."""
    from scipy import ndimage

    ids = np.unique(m)
    ids = ids[ids >= 0]
    best = np.full(m.shape, -1, np.int64)
    bestv = np.zeros(m.shape, np.float32)
    for iid in ids:
        s = ndimage.uniform_filter((m == iid).astype(np.float32), size=size)
        take = s > bestv
        best[take] = iid
        bestv[take] = s[take]
    return best


def _prompt_rng(iid: int, row: int, col: int, seed: int):
    # splitmix-style hash: deterministic across epochs and processes
    h = (
        (int(iid) + 1) * 0x9E3779B97F4A7C15
        ^ int(row) * 0xBF58476D1CE4E5B9
        ^ int(col) * 0x94D049BB133111EB
        ^ int(seed)
    ) & 0xFFFFFFFFFFFFFFFF
    return np.random.default_rng(h)


class OracleSamPredictor:
    """Duck-typed SamPredictor over per-frame instance-id maps."""

    def __init__(self, quality: float = 0.7, d0: float = 12.0,
                 seed: int = 0):
        self.quality = float(quality)
        self.d0 = float(d0)
        self.seed = int(seed)
        self._features: Optional[np.ndarray] = None  # (H, W) int32 id map
        self._orig_size: Optional[Tuple[int, int]] = None

    # -- SamPredictor surface --------------------------------------------
    @property
    def features(self):
        return self._features

    def set_features(self, features, orig_size: Tuple[int, int]):
        m = np.asarray(features)
        m = np.squeeze(m)
        assert m.ndim == 2, (
            "oracle features must be an (H, W) instance-id map; got "
            f"{m.shape} — regenerate embeddings with sam_oracle=True"
        )
        self._features = _clean_id_map(m.astype(np.int64))
        self._orig_size = tuple(orig_size)

    def predict(self, point_coords, point_labels, multimask_output=True,
                return_logits=False):
        """(P, n, 2)/(n, 2) prompts -> (masks (P, 1, H, W) bool,
        iou (P, 1), low_res None-shaped placeholder)."""
        assert self._features is not None, "call set_features first"
        pts = np.asarray(point_coords, np.float32)
        if pts.ndim == 2:
            pts = pts[None]
        masks, iou = self._decode_frame(self._features, pts[:, 0, :])
        return masks[:, None], iou[:, None], np.zeros(
            (masks.shape[0], 1, 1, 1), np.float32
        )

    def predict_batch(self, features, point_coords, point_labels,
                      orig_size: Tuple[int, int],
                      mask_index: Optional[int] = None):
        """(F, H, W) id maps x (F, P, n, 2) prompts ->
        (masks (F, P, 1, H, W) bool, iou (F, P, 1))."""
        feats = np.asarray(features)
        if feats.ndim == 2:
            feats = feats[None]
        pts = np.asarray(point_coords, np.float32)
        lbl = np.asarray(point_labels)
        F, P = pts.shape[:2]
        h, w = feats.shape[-2:]
        # fill in place: np.stack of (P, H, W) bool frames is a huge copy
        out_m = np.zeros((F, P, 1, h, w), bool)
        out_i = np.zeros((F, P, 1), np.float32)
        for f in range(feats.shape[0]):
            m = _clean_id_map(np.squeeze(feats[f]).astype(np.int64))
            live = lbl[f, :, 0] >= 0  # label -1 = padding prompt
            masks, iou = self._decode_frame(
                m, pts[f, :, 0, :], live=live
            )
            out_m[f, :, 0] = masks
            out_i[f, :, 0] = iou
        return out_m, out_i

    # -- decode ----------------------------------------------------------
    def _decode_frame(self, id_map: np.ndarray, pts: np.ndarray, live=None):
        """id_map (H, W), pts (P, 2) original-resolution (x, y) ->
        (masks (P, H, W) bool, iou (P,) f32). ``live`` masks padding
        prompts (skipped, empty output).

        Per-frame caches make the prompt loop cheap: the exact instance
        masks (shared by every prompt on the same instance) and the
        (yy, xx) coordinate grid for half-plane cuts are computed once."""
        h, w = id_map.shape
        P = pts.shape[0]
        masks = np.zeros((P, h, w), bool)
        ious = np.zeros(P, np.float32)
        # masks are sampled at [v-1, u-1] downstream (labels.py /
        # train_real.py index convention), so the prompt lands there too
        rows = np.clip(np.round(pts[:, 1]).astype(np.int64) - 1, 0, h - 1)
        cols = np.clip(np.round(pts[:, 0]).astype(np.int64) - 1, 0, w - 1)
        cache = {"inst": {}, "grid": np.mgrid[0:h, 0:w]}
        for p in range(P):
            if live is not None and not live[p]:
                continue
            masks[p], ious[p] = self._one_mask(
                id_map, rows[p], cols[p], cache=cache
            )
        return masks, ious

    @staticmethod
    def _inst_mask(id_map, iid, cache):
        if cache is None:
            return id_map == iid
        m = cache["inst"].get(iid)
        if m is None:
            m = cache["inst"][iid] = id_map == iid
        return m

    _N_RING = 16
    _RING_TOL = 0.3  # boundary only when >30% of painted samples disagree

    def _probe(self, id_map, row, col, iid):
        """(interior distance, id of the nearest different instance).

        Point-splat id maps are speckled — far instances poke through
        between a near surface's sparse points — so a single disagreeing
        pixel is not a boundary. A ring counts as crossing a boundary
        only when more than ``_RING_TOL`` of its painted samples belong
        to another instance."""
        h, w = id_map.shape
        ang = 2 * np.pi * np.arange(self._N_RING) / self._N_RING
        dy, dx = np.sin(ang), np.cos(ang)
        other = -1
        for r in _RINGS:
            ys = np.clip((row + r * dy).round().astype(np.int64), 0, h - 1)
            xs = np.clip((col + r * dx).round().astype(np.int64), 0, w - 1)
            ring = id_map[ys, xs]
            painted = ring[ring >= 0]
            diff = painted[painted != iid]
            if painted.size and diff.size > self._RING_TOL * painted.size:
                ids, cnt = np.unique(diff, return_counts=True)
                return float(r), int(ids[np.argmax(cnt)])
            if diff.size and other < 0:
                other = int(diff[0])
        return float(_RINGS[-1]), other

    def _one_mask(self, id_map, row, col, _search: int = 3, cache=None):
        iid = int(id_map[row, col])
        if iid < 0:
            # prompt on a hole: snap to the nearest painted pixel, like a
            # real SAM would still segment *something* under the prompt
            h, w = id_map.shape
            win = id_map[max(row - _search, 0): row + _search + 1,
                         max(col - _search, 0): col + _search + 1]
            cand = win[win >= 0]
            if cand.size == 0:
                return np.zeros_like(id_map, bool), 0.0
            iid = int(cand[0])
        mask = self._inst_mask(id_map, iid, cache)
        d, neighbour = self._probe(id_map, row, col, iid)
        # interiorness RELATIVE to the instance's apparent size, CAPPED
        # at 1.5*d0: a real SAM segments an object cleanly from any
        # prompt a couple dozen pixels inside it regardless of object
        # size, and degrades near its boundary. Without the cap, large
        # fixtures-bearing surfaces (walls with boards/doors, floors
        # under furniture) have NO pixel interior enough (0.4*r_inst can
        # exceed any achievable boundary distance), so their every decode
        # was corrupted — per-vote paint precision 0.53 on the proxy vs
        # real SAM's near-1.0 for interior prompts. d0/4 stays the floor
        # for tiny-on-screen instances.
        r_inst = float(np.sqrt(mask.sum() / np.pi))
        scale = max(self.d0 / 4.0, min(0.4 * r_inst, 1.5 * self.d0))
        p_good = self.quality * min(1.0, 0.15 + 0.85 * d / scale)
        rng = _prompt_rng(iid, row, col, self.seed)
        iou = float(np.clip(p_good + 0.1 * (rng.random() - 0.5), 0.0, 1.0))
        if rng.random() < p_good:
            return mask, iou
        if neighbour >= 0 and rng.random() < 0.5:
            # BLEED: merge with the *nearby part* of the adjacent
            # instance. A real SAM that leaks across a boundary grabs the
            # touching region of the neighbour, not its whole extent —
            # unioning the full neighbour mask let one corrupted chair
            # prompt paint the entire visible floor (and a board prompt
            # the entire wall), which dominated the pseudo-label
            # confusion (floor->furniture, wall->fixture classes).
            from scipy import ndimage

            nb = self._inst_mask(id_map, neighbour, cache)
            dist = ndimage.distance_transform_edt(~mask)
            return mask | (nb & (dist <= self.d0)), iou
        # PARTIAL: cut by a half-plane through a point offset from the
        # prompt along a deterministic-random normal
        h, w = id_map.shape
        theta = rng.uniform(0, 2 * np.pi)
        n = np.array([np.cos(theta), np.sin(theta)])
        off = rng.uniform(2.0, max(3.0, d + 2.0))
        yy, xx = cache["grid"] if cache else np.mgrid[0:h, 0:w]
        side = (yy - (row + off * n[0])) * n[0] + (
            xx - (col + off * n[1])
        ) * n[1] <= 0
        return mask & side, iou
