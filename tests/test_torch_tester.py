"""The whole slice: ao_tpu_torch's SemSegTester against ao_tpu's on one
tiny synthetic S3DIS scene, with the same weights (the JAX variables,
read by the port from an .npz through convert.from_jax_variables)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from __graft_entry__ import _flagship_cfg
from ao_tpu.engines.test import SemSegTester as JaxTester
from ao_tpu.models import build_model as jax_build_model
from ao_tpu.utils.checkpoint import save_checkpoint
from ao_tpu.utils.config import Config as JaxConfig
from ao_tpu_torch.engines import TEST
from ao_tpu_torch.utils import Config


def _cfg(root, save_path, weight, backend):
    model = _flagship_cfg(tiny=True)
    model["backbone"]["unpool_backend"] = backend
    test = dict(
        type="S3DISDataset", split="Area_5", data_root=root,
        transform=[dict(type="CenterShift", apply_z=True),
                   dict(type="NormalizeColor")],
        test_mode=True,
        test_cfg=dict(
            voxelize=dict(type="GridSample", grid_size=0.04, hash_type="fnv",
                          mode="test", keys=("coord", "color"),
                          return_discrete_coord=True),
            crop=None,
            post_transform=[
                dict(type="CenterShift", apply_z=False),
                dict(type="ToTensor"),
                dict(type="Collect", keys=("coord", "discrete_coord", "index"),
                     feat_keys=("coord", "color")),
            ],
            aug_transform=[
                [dict(type="RandomScale", scale=[1, 1], anisotropic=True)],
                [dict(type="RandomScale", scale=[1.05, 1.05], anisotropic=True),
                 dict(type="RandomFlip", p=1)],
            ],
        ),
    )
    return dict(model=model, weight=weight, save_path=save_path,
                pad_multiple=512, test_fragments_per_batch=16,
                data=dict(num_classes=13, ignore_index=-1, test=test))


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("backend", ["map", "interp"])
def test_semseg_tester_matches_jax(tmp_path, backend):
    root = tmp_path / "s3dis"
    os.makedirs(root / "Area_5")
    np.savez(root / "Area_5" / "office_1.npz",
             **chip_smoke.make_room(1, size=(1.0, 0.8, 0.5)))

    rng = np.random.default_rng(0)
    model = jax_build_model(_cfg("", "", "", backend)["model"])
    x = jnp.asarray(rng.uniform(0, 1, (1, 128, 3)).astype(np.float32))
    var = jax.jit(model.init)(jax.random.PRNGKey(0), x,
                              jnp.concatenate([x, x], -1),
                              jnp.ones((1, 128), bool))
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.asarray(
            (rng.uniform(0.5, 1.5, v.shape) if "var" in str(p[-1])
             else rng.normal(0, 0.1, v.shape)).astype(np.float32)),
        var["batch_stats"])
    variables = {"params": var["params"], "batch_stats": stats}
    jax_weight = str(tmp_path / "model.ckpt")
    save_checkpoint(jax_weight, variables)
    npz_weight = str(tmp_path / "model.npz")
    np.savez(npz_weight, **_flat(variables, ""))

    jcfg = JaxConfig(_cfg(str(root), str(tmp_path / "jax"), jax_weight, backend))
    jres = JaxTester(jcfg)()
    tcfg = Config(_cfg(str(root), str(tmp_path / "port"), npz_weight, backend))
    tres = TEST.build(dict(type="SemSegTester", cfg=tcfg, device="cpu"))()

    jv = np.load(tmp_path / "jax" / "result" / "office_1_pred.npy")
    tv = np.load(tmp_path / "port" / "result" / "office_1_pred.npy")
    n_votes = jv.sum(-1, keepdims=True)
    assert n_votes.min() >= 2 - 1e-3  # both views voted on every point
    assert (tv.argmax(-1) == jv.argmax(-1)).mean() >= 0.999
    assert np.abs(tv - jv).max() <= 2e-3 * n_votes.max()
    assert np.abs((tv - jv) / n_votes).max() <= 2e-3
    assert abs(tres["mIoU"] - jres["mIoU"]) < 1e-2
    assert tres["scenes"][0]["fragments"] > 2
