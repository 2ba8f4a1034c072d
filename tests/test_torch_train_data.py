"""The train transforms of the S3DIS base config and the seeded train
loader of ao_tpu_torch, against ao_tpu's transforms where the random draw
can be fixed (p = 0 / 1, fixed blend factors, a crop centre given to both)
and otherwise by shape, range and the set of kept points."""

import numpy as np
import torch

import ao_tpu.datasets.transform as jt
import chip_smoke
from ao_tpu_torch.datasets import transform as tt


def _cloud(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    return dict(coord=rng.uniform(0, 3, (n, 3)).astype(np.float32),
                color=rng.uniform(0, 255, (n, 3)).astype(np.float32),
                segment=rng.integers(0, 13, n))


def _copy(d):
    return {k: v.copy() for k, v in d.items()}


def test_chromatic_transforms_fixed_draws_match_jax():
    """p=0: the identity in both; ChromaticAutoContrast at p=1 with a fixed
    blend factor: the same colours as ao_tpu's (1e-4)."""
    d = _cloud()
    for name, kw in (("ChromaticAutoContrast", dict(p=0.0)),
                     ("ChromaticTranslation", dict(p=0.0)),
                     ("ChromaticJitter", dict(p=0.0))):
        out = getattr(tt, name)(**kw)(_copy(d))
        assert np.array_equal(out["color"], d["color"]), name
    j = jt.ChromaticAutoContrast(p=1.0, blend_factor=0.3)(_copy(d))
    t = tt.ChromaticAutoContrast(p=1.0, blend_factor=0.3)(_copy(d))
    assert np.abs(t["color"] - j["color"]).max() < 1e-4


def test_random_draw_transforms_shape_and_range():
    """Where the draw differs between the packages: RandomJitter moves each
    point by at most ``clip`` with about ``sigma`` spread; ChromaticJitter
    adds noise of about std * 255 and ChromaticTranslation one offset for
    all points of at most 255 * ratio, both clipped to [0, 255]; the draws
    come from the transform's generator (same seed, same result)."""
    d = _cloud(20000)
    g = torch.Generator().manual_seed(3)
    out = tt.RandomJitter(sigma=0.005, clip=0.02, generator=g)(_copy(d))
    delta = out["coord"] - d["coord"]
    assert np.abs(delta).max() <= 0.02 + 1e-6
    assert abs(delta.std() - 0.005) < 5e-4
    out2 = tt.RandomJitter(sigma=0.005, clip=0.02,
                           generator=torch.Generator().manual_seed(3))(_copy(d))
    assert np.array_equal(out["coord"], out2["coord"])
    c = dict(d, color=np.full_like(d["color"], 128.0))
    out = tt.ChromaticJitter(p=1.0, std=0.05, generator=g)(_copy(c))
    assert abs((out["color"] - 128.0).std() - 0.05 * 255) < 0.5
    out = tt.ChromaticTranslation(p=1.0, ratio=0.05, generator=g)(_copy(c))
    shift = out["color"] - 128.0
    assert np.abs(shift).max() <= 255 * 0.05 + 1e-4
    assert np.allclose(shift, shift[:1])
    out = tt.ChromaticJitter(p=1.0, std=5.0, generator=g)(_copy(d))
    assert out["color"].min() >= 0.0 and out["color"].max() <= 255.0


def test_grid_sample_train_keeps_one_point_per_voxel():
    """Train mode keeps one point of every occupied voxel, like ao_tpu's:
    the same set of voxels, each kept point inside its voxel, and the same
    discrete coordinates for the voxels."""
    d = _cloud(5000)
    kw = dict(grid_size=0.2, hash_type="fnv", mode="train",
              keys=("coord", "color", "segment"), return_discrete_coord=True)
    j = jt.GridSample(**kw)(_copy(d))
    t = tt.GridSample(generator=torch.Generator().manual_seed(0), **kw)(_copy(d))
    assert len(t["coord"]) == len(j["coord"])
    key = lambda dc: set(map(tuple, dc.tolist()))  # noqa: E731
    assert key(t["discrete_coord"]) == key(j["discrete_coord"])
    assert len(key(t["discrete_coord"])) == len(t["coord"])
    lo = d["coord"].min(0)
    assert np.array_equal(np.floor(t["coord"] / 0.2).astype(int)
                          - np.floor(lo / 0.2).astype(int), t["discrete_coord"])


def test_sphere_crop_matches_jax(monkeypatch):
    """A cloud no larger than point_max passes unchanged in both; a larger
    one keeps the point_max points nearest the drawn centre, exactly as
    ao_tpu's with the same centre."""
    d = _cloud(3000)
    for mod in (jt, tt):
        out = mod.SphereCrop(point_max=3000, mode="random")(_copy(d))
        assert all(np.array_equal(out[k], d[k]) for k in d)
    g = torch.Generator().manual_seed(5)
    i = int(torch.randint(0, 3000, (1,), generator=torch.Generator().manual_seed(5)))
    t = tt.SphereCrop(point_max=1000, mode="random", generator=g)(_copy(d))
    monkeypatch.setattr(jt.np.random, "randint", lambda n: i)
    j = jt.SphereCrop(point_max=1000, mode="random")(_copy(d))
    assert all(np.array_equal(t[k], j[k]) for k in d)
    dist = ((d["coord"] - d["coord"][i]) ** 2).sum(1)
    assert ((t["coord"] - d["coord"][i]) ** 2).sum(1).max() <= np.sort(dist)[999]


def test_base_config_train_pipeline_and_loader(tmp_path):
    """The base config's train transforms on a synthetic room and the
    Trainer's loader: padded (B, N) batches with N a multiple of
    pad_multiple, features [coord | colour in [-1, 1]], the ignore label on
    padding, at most 80000 points a sample, and a shuffle order that the
    seed fixes and each epoch redraws."""
    rooms = [chip_smoke.make_room(s, (1.6, 1.2, 1.0)) for s in (1, 2, 3, 4)]
    _, options = chip_smoke.train_setup(rooms, str(tmp_path), batch_size=2,
                                        workers=0, seed=7)
    trainer = chip_smoke.build_trainer(options + ["pad_multiple=1024"], "cpu")
    loader = trainer.train_loader
    assert len(loader) == 4 * 30 // 2  # the base config loops 30x
    batch = next(iter(loader))
    mask, feat, seg = batch["mask"], batch["feat"], batch["segment"]
    assert mask.shape[1] % 1024 == 0 and mask.shape[0] == 2
    assert feat.shape[-1] == 6 and seg.dtype == torch.int32
    assert (seg[~mask] == -1).all() and (seg[mask] >= 0).all()
    assert feat[mask][:, 3:].abs().max() <= 1.0
    assert torch.equal(feat[mask][:, :3], batch["coord"][mask])
    assert int(mask.sum(1).max()) <= 80000

    def orders(t, epochs=2):  # the loader's sample order in each epoch
        return [list(t.train_loader.sampler) for _ in range(epochs)]

    a, b = (orders(chip_smoke.build_trainer(options + ["pad_multiple=1024"],
                                            "cpu")) for _ in range(2))
    assert a == b and a[0] != a[1]
