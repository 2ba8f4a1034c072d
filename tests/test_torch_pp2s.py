"""The port's PP2S pipeline, oracle SAM and label evaluation against
ao_tpu's: both pipelines run every stage in oracle mode on the same three
small synthetic rooms (chip_smoke.make_room, with instance ids), the port
through its CLI, and every file they write must be equal, bit for bit
(PNG frames pixel for pixel); then the neural-SAM stages on one room with
the same tiny SAM weights on both sides."""

import json
import os
import pickle

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from ao_tpu.engines import label_eval as jax_label_eval
from ao_tpu.models.sam.oracle import OracleSamPredictor as JaxOracle
from ao_tpu.pp2s import PP2SPipeline as JaxPP2S
from ao_tpu_torch.engines import label_eval
from ao_tpu_torch.models.sam import OracleSamPredictor
from ao_tpu_torch.tools.evaluate_labels import main as evaluate_main
from ao_tpu_torch.tools.pp2s import main as pp2s_main

AREAS = ("Area_1", "Area_2", "Area_3")
SIZE = 96  # frame pixels


def write_rooms(root, seeds=(1, 2, 3), size=(1.6, 1.4, 1.0), spacing=0.05):
    for i, seed in enumerate(seeds):
        room_dir = os.path.join(root, "s3dis", f"Area_{i + 1}")
        os.makedirs(room_dir, exist_ok=True)
        np.savez(os.path.join(room_dir, f"office_{i}.npz"),
                 **chip_smoke.make_room(seed, size, spacing))


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """Both pipelines' outputs: (ao_tpu root, port root, port pipeline)."""
    roots = []
    for name in ("jax", "port"):
        root = str(tmp_path_factory.mktemp(name))
        write_rooms(root)
        roots.append(root)
    jax_pipe = JaxPP2S(data_root=roots[0], areas=AREAS, sam_oracle=True,
                       bridge_depth_thresh=0.02)
    jax_pipe.run_render_frames(views=2, size=SIZE)
    jax_pipe.run_all(frame_size=(SIZE, SIZE))
    common = ["--data-root", roots[1], "--sam-oracle", "--frame-size",
              str(SIZE), "--bridge-depth-thresh", "0.02", "--areas", *AREAS,
              "--device", "cpu"]
    pp2s_main(common + ["--stage", "render_frames", "--render-views", "2"])
    pipe = pp2s_main(common + ["--stage", "all"])
    return roots[0], roots[1], pipe


def _files(root):
    out = set()
    for d, _, names in os.walk(root):
        for n in names:
            out.add(os.path.relpath(os.path.join(d, n), root))
    return out


def _load(path):
    if path.endswith(".png"):
        im = Image.open(path)
        return im.mode, np.asarray(im)
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    if path.endswith(".pickle"):
        with open(path, "rb") as f:
            return pickle.load(f)
    with open(path) as f:
        return f.read()


def _equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("stage", [
    "S2D3D", "used_imgs", "embeddings", "bridge", "weak_labels",
    "sam_labels", "basket_s3dis.pickle",
])
def test_stage_outputs_equal_bit_for_bit(pipelines, stage):
    jax_root, port_root, _ = pipelines
    want = {f for f in _files(jax_root) if f.split(os.sep)[0] == stage}
    got = {f for f in _files(port_root) if f.split(os.sep)[0] == stage}
    assert want and got == want
    if stage == "S2D3D":  # rgb, depth and pose of 2 + 2 views a room
        assert len(want) == 3 * 4 * 3
    for rel in sorted(want):
        a = _load(os.path.join(jax_root, rel))
        b = _load(os.path.join(port_root, rel))
        assert _equal(b, a), rel


def test_every_stage_timed_and_sam_labels_cover_points(pipelines):
    _, port_root, pipe = pipelines
    assert set(pipe.stage_seconds) == {"embeddings", "bridges", "weak_labels",
                                       "basket", "sam_labels"}
    lab = np.load(os.path.join(port_root, "sam_labels", "Area_1", "office_0.npy"))
    assert (lab >= 0).mean() > 0.1  # the oracle's masks label many points


def test_oracle_predict_batch_bit_for_bit(pipelines):
    _, port_root, _ = pipelines
    emb_dir = os.path.join(port_root, "embeddings", "Area_2", "office_1")
    feats = np.stack([np.load(os.path.join(emb_dir, f))["features"]
                      for f in sorted(os.listdir(emb_dir))[:3]])
    rng = np.random.default_rng(0)
    pts = rng.uniform(1, SIZE, (3, 16, 1, 2)).astype(np.float32)
    lbl = np.ones((3, 16, 1), np.int32)
    lbl[:, 11:] = -1  # pad prompts
    want = JaxOracle(quality=0.8).predict_batch(feats, pts, lbl, (SIZE, SIZE), 0)
    got = OracleSamPredictor(quality=0.8).predict_batch(feats, pts, lbl,
                                                        (SIZE, SIZE), 0)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert want[0].any() and not want[0][:, 11:].any()
    one = OracleSamPredictor(quality=0.8)
    one.set_features(feats[0], (SIZE, SIZE))
    ref = JaxOracle(quality=0.8)
    ref.set_features(feats[0], (SIZE, SIZE))
    for a, b in zip(one.predict(pts[0], lbl[0]), ref.predict(pts[0], lbl[0])):
        assert np.array_equal(a, b)


def test_label_eval_equal(pipelines, capsys):
    jax_root, port_root, _ = pipelines
    args = (os.path.join(port_root, "sam_labels"),
            os.path.join(port_root, "s3dis"), 13)
    got = label_eval.get_miou(*args, areas=AREAS)
    want = jax_label_eval.get_miou(*args, areas=AREAS)
    assert got == want and got["num_scenes"] == 3
    assert evaluate_main([args[0], "--data-root", args[1], "--areas", *AREAS]) == want
    assert "mIoU" in capsys.readouterr().out
    preds, gts = {}, {}
    for i, area in enumerate(AREAS):
        preds[area] = np.load(os.path.join(
            port_root, "sam_labels", area, f"office_{i}.npy")).reshape(-1)
        with np.load(os.path.join(port_root, "s3dis", area, f"office_{i}.npz")) as z:
            gts[area] = z["semantic_gt"].reshape(-1)
    assert (label_eval.get_miou_from_arrays(preds, gts, 13)
            == jax_label_eval.get_miou_from_arrays(preds, gts, 13))


def test_neural_embeddings_and_sam_labels_match_ao_tpu(pipelines, tmp_path):
    """PP2S stages 1 and 5 with a neural SAM (SamConfig.tiny(), the same
    weights on both sides, carried across as in test_torch_sam.py) on one
    room's rendered 96^2 frames: embeddings within 1e-4 of scale, SAM
    labels on at least 0.99 of the points."""
    import shutil

    from ao_tpu.models.sam import SamConfig as JaxSamConfig
    from ao_tpu.models.sam import SamPredictor as JaxSamPredictor
    from ao_tpu.models.sam.convert import convert_original_checkpoint
    from ao_tpu_torch.models.sam import SamConfig, SamPredictor, build_sam
    from ao_tpu_torch.pp2s import PP2SPipeline
    from tests.test_torch_sam import _flax_as_torch, _gelu

    _, port_root, _ = pipelines
    sd = build_sam(SamConfig.tiny(), seed=1, device="cpu").state_dict()
    flax = convert_original_checkpoint({k: v.numpy() for k, v in sd.items()})
    roots = {}
    for side in ("jax", "port"):
        root = str(tmp_path / side)
        for d in ("s3dis", "S2D3D", "used_imgs", "bridge", "weak_labels"):
            shutil.copytree(os.path.join(port_root, d), os.path.join(root, d))
        roots[side] = root
    jax_pipe = JaxPP2S(data_root=roots["jax"], areas=("Area_1",))
    jax_pipe._predictor = JaxSamPredictor(JaxSamConfig.tiny(), _flax_as_torch(flax))
    port_pipe = PP2SPipeline(data_root=roots["port"], areas=("Area_1",),
                             device="cpu")
    port_pipe._predictor = SamPredictor(SamConfig.tiny(), sd, device="cpu")
    _gelu(port_pipe._predictor._ensure_model())
    for pipe in (jax_pipe, port_pipe):
        pipe.run_embeddings()
        pipe.run_sam_labels(frame_size=(SIZE, SIZE))
    emb = os.path.join("embeddings", "Area_1", "office_0")
    names = sorted(os.listdir(os.path.join(roots["jax"], emb)))
    assert len(names) == 4
    for n in names:
        a = _load(os.path.join(roots["jax"], emb, n))["features"]
        b = _load(os.path.join(roots["port"], emb, n))["features"]
        assert a.shape == b.shape == (8, 8, 16)
        # measured: 9.5e-7 at most
        assert np.abs(b - a).max() < 1e-4 * np.abs(a).max()
    lab = os.path.join("sam_labels", "Area_1", "office_0.npy")
    a, b = (np.load(os.path.join(roots[s], lab)) for s in ("jax", "port"))
    assert a.shape == b.shape and (a >= 0).any()
    assert (a == b).mean() >= 0.99  # measured: 1.0 (2.3% of points labelled)
