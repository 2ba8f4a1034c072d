"""The FLOP and byte counts on hand-worked shapes, and the room mix."""

import json
import os

import numpy as np
import pytest
import torch

from gpubench.counts import ptv2m2
from gpubench.harness import rooms
from gpubench.harness.peaks import H100, matmul_peak
from gpubench.tests.tiny import ROOT

# a one-stage backbone small enough to count by hand
B1 = dict(in_channels=6, num_classes=4, patch_embed_channels=8,
          patch_embed_groups=2, patch_embed_neighbours=4, patch_embed_depth=1,
          enc_depths=(1,), enc_channels=(16,), enc_groups=(4,),
          enc_neighbours=(4,), dec_depths=(1,), dec_channels=(8,),
          dec_groups=(2,), dec_neighbours=(4,), grid_sizes=(1.0,),
          stage_cap_ratios=(0.5,), unpool_backend="map")


def test_gpubench_block_flops_by_hand():
    # C=8, G=2, S=4: 10 C^2 = 640; a slot: 6C + 2C^2 + 2CG + 2G^2 + 2C
    # = 48 + 128 + 32 + 8 + 16 = 232, times 4 slots = 928
    assert ptv2m2._block_flops(8, 2, 4) == 640 + 928


def test_gpubench_forward_flops_by_hand():
    n = [10, 3]  # valid points at the two resolutions
    expect = (2 * 6 * 8 * 10  # patch embed proj
              + 10 * ptv2m2._block_flops(8, 2, 4)  # patch embed block
              + 3 * ptv2m2._block_flops(16, 4, 4)  # encoder block
              + 10 * ptv2m2._block_flops(8, 2, 4)  # decoder block
              + 2 * 8 * 16 * 10  # grid pool's fc
              + 2 * 16 * 8 * 3 + 2 * 8 * 8 * 10  # unpool proj, proj_skip
              + (2 * 8 * 8 + 2 * 8 * 4) * 10)  # seg head
    assert ptv2m2.forward_flops(B1, n) == expect


def test_gpubench_stage_sizes_by_hand():
    # row 0: 4 points in two unit voxels, row 1: 3 points in three voxels
    # and one padded row
    coord = torch.tensor([[[0.1, 0.1, 0.1], [0.2, 0.2, 0.2], [1.5, 0.1, 0.1],
                           [1.6, 0.2, 0.1]],
                          [[0.1, 0.1, 0.1], [1.5, 0.1, 0.1], [3.5, 0.1, 0.1],
                           [0.0, 0.0, 0.0]]])
    mask = torch.tensor([[True] * 4, [True, True, True, False]])
    sizes = ptv2m2.stage_sizes(coord, mask, B1)
    assert sizes[0].tolist() == [4, 3]
    # (capacities have a floor of 64 rows: nothing merges here)
    assert sizes[1].tolist() == [2, 3]
    # 200 points in 200 voxels with a capacity of int(200 * 0.5) = 100:
    # the clusters past it merge into the last
    coord = torch.arange(200.0)[None, :, None].expand(1, 200, 3).contiguous()
    sizes = ptv2m2.stage_sizes(coord, torch.ones(1, 200, dtype=torch.bool), B1)
    assert sizes[1].tolist() == [100]


def test_gpubench_kernel_bounds_by_hand():
    b = dict(B1, patch_embed_depth=1)
    out = ptv2m2.kernel_bounds(b, (1, 16), [10, 3], train=True)
    C, G, S = 8, 2, 4
    # K6 operations of the patch embed block and the decoder block at C=8
    # (10 points, 40 slots each) and the encoder block at C=16 (3 points)
    mm8 = 40 * (2 * 3 * C + 6 * C * C + 6 * C * G + 12 * C * (1 + G))
    mm16 = 12 * (2 * 3 * 16 + 6 * 256 + 6 * 16 * 4 + 12 * 16 * 5)
    assert out["gva_bwd"][0] == 2 * mm8 + mm16
    f32 = 2 * 40 * (6 * G * G + 36 * C) + 12 * (6 * 16 + 36 * 16)
    assert out["gva_bwd"][1] == f32
    # off the slab path (N < 2048): one probe a resolution (N <= 1152);
    # the window is the whole stage; stage 1 holds the floor of 64 rows
    calls = ptv2m2.knn_calls(b, 1, [16, 64])
    assert calls == [(1, 16, 128, 16, 4), (1, 64, 128, 64, 4)]
    assert out["knn_window"][1] == 8.0 * (16 * 16 + 64 * 64)
    t = ptv2m2.bound_seconds(1e12, 0.0, 0.0, H100)
    assert t == pytest.approx(1e12 / 989e12)
    assert ptv2m2.bound_seconds(0.0, 0.0, 3.35e12, H100) == pytest.approx(1.0)


def test_gpubench_slab_windows_match_the_path():
    # the window geometry of the S3DIS stages at 81920 points: (128, 640)
    # x2, (128, 512), (64, 512) as the kernel table lists them
    assert ptv2m2._slab(48, 81920)[:2] == (128, 640)
    assert ptv2m2._slab(96, 28672)[:2] == (128, 640)
    assert ptv2m2._slab(192, 10035)[:2] == (128, 512)
    assert ptv2m2._slab(384, 3512)[:2] == (64, 512)
    assert ptv2m2._slab(512, 3512) is None and ptv2m2._slab(48, 2000) is None


def test_gpubench_peaks():
    assert matmul_peak("bf16", False) == 989e12
    assert matmul_peak("f32", False) == 67e12
    assert matmul_peak("f32", True) == 495e12


@pytest.mark.parametrize("mix", ["s3dis-rooms.train", "scannet-rooms.train"])
def test_gpubench_room_mix_is_the_same_work_across_seeds(mix):
    """Every seed offers the same rooms: the same kinds and sizes, and raw
    point counts within 1% a room (only jitter, colour and clutter draws
    change)."""
    with open(os.path.join(ROOT, "gpubench", "traffic", mix + ".json")) as f:
        t = json.load(f)
    m = dict(t["rooms"], spacing=0.1)  # fewer points, the same rule
    sizes = rooms.room_sizes(m)
    assert len(sizes) == m["count"]
    kinds = [k for k, _ in sizes]
    assert "hallway" in kinds and "conference" in kinds
    counts = []
    for seed in (1, 2**31 + 5, 987654321):
        counts.append([len(rooms.make_room(s, size, m["spacing"])["coord"])
                       for s, (_, size) in zip(rooms.room_seeds(seed, m["count"]),
                                               sizes)])
    counts = np.array(counts, float)
    assert (np.abs(counts / counts[0] - 1) <= 0.01).all()


def test_gpubench_room_sizes_fixed_quantiles():
    mix = dict(count=4, default="office", every={"hallway": 4},
               sizes={"office": [[3, 6], [3, 6], [2.6, 3.2]],
                      "hallway": [[10, 20], [2, 2], [3, 3]]})
    sizes = rooms.room_sizes(mix)
    # 3 offices: X at quantiles 1/6, 1/2, 5/6 of [3, 6]
    assert [s[1][0] for s in sizes[:3]] == [3.5, 4.5, 5.5]
    assert sizes[3] == ("hallway", (15.0, 2.0, 3.0))


def test_gpubench_scannet_normals_are_unit_and_face_in():
    r = rooms.make_room(3, (4.0, 3.0, 2.8), 0.2)
    n = r["normal"]
    assert np.allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-5)
    inward = np.einsum("ni,ni->n", n, r["coord"].mean(0) - r["coord"])
    assert (inward >= -1e-4).all()
