"""The port's SAM (ao_tpu_torch/models/sam/) against ao_tpu's flax SAM at
SamConfig.tiny(), with the flax weights carried across by
flax_to_torch_state_dict, and its resizes against jax.image.resize.

The flax module differs from the official segment_anything (whose
parameter names and semantics the port keeps) in two places, and the
numeric comparisons give the flax side what makes it the same function:
its two-way blocks' MLP is GELU (the port's, the official ReLU, is
swapped for GELU here), and its ConvTranspose applies a kernel spatially
flipped against torch's ConvTranspose2d (the flax side gets the
upscaling kernels flipped).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ao_tpu.models.sam import SamConfig as JaxSamConfig
from ao_tpu.models.sam import SamModel as JaxSamModel
from ao_tpu.models.sam import SamPredictor as JaxSamPredictor
from ao_tpu.models.sam.convert import convert_original_checkpoint
from ao_tpu_torch.models.sam import (
    SamConfig, SamModel, SamPredictor, build_sam, convert_hf_state_dict,
    flax_to_torch_state_dict,
)
from ao_tpu_torch.models.sam.predictor import resize_linear


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module")
def flax_params():
    """Tiny flax SAM params, every leaf drawn from a seed (nonzero position
    embeddings too), as ao_tpu's convert_original_checkpoint lays out a
    checkpoint with official names (the two positional Gaussians tied)."""
    rng = np.random.default_rng(0)
    sd = {}
    for k, v in SamModel(SamConfig.tiny()).state_dict().items():
        if k.endswith(".bias") or v.dim() == 1:
            x = 0.1 * rng.standard_normal(v.shape)
            if k.endswith(".weight"):  # LayerNorm scales
                x += 1.0
        else:
            x = rng.standard_normal(v.shape) / np.sqrt(v[0].numel())
        sd[k] = x.astype(np.float32)
    return _to_dict(convert_original_checkpoint(sd))


def _to_dict(tree):
    return {k: _to_dict(v) if hasattr(v, "items") else v for k, v in tree.items()}


def _flax_as_torch(params):
    """The flax params that compute torch's ConvTranspose2d with the same
    weights: the upscaling kernels flipped in both spatial axes."""
    out = _to_dict(params)
    for name in ("upscale_conv1", "upscale_conv2"):
        k = out["mask_decoder"][name]["kernel"]
        out["mask_decoder"][name] = dict(out["mask_decoder"][name],
                                         kernel=np.ascontiguousarray(k[::-1, ::-1]))
    return {"params": out}


def _gelu(model):
    """The port's model with ao_tpu's GELU in the two-way blocks' MLP."""
    for block in model.mask_decoder.transformer.layers:
        block.mlp.act = torch.nn.GELU()
    return model


def _load(model, sd):
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected
    assert all(k.startswith("prompt_encoder.mask_downscaling.") for k in missing)
    return model.eval()


@pytest.fixture(scope="module")
def port_model(flax_params):
    return _gelu(_load(SamModel(SamConfig.tiny()), flax_to_torch_state_dict(flax_params)))


def _rel_err(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def test_round_trip_through_ao_tpu_converter(flax_params):
    sd = flax_to_torch_state_dict(flax_params)
    # every official name of the port's model, no other
    assert set(sd) == set(SamModel(SamConfig.tiny()).state_dict())
    back = _to_dict(convert_original_checkpoint({k: v.numpy() for k, v in sd.items()}))
    want = dict(_leaves(flax_params))
    got = dict(_leaves(back))
    assert set(got) == set(want)
    for path, x in want.items():
        assert got[path].shape == x.shape, path
        assert np.array_equal(got[path], x), path


def test_untied_positional_gaussians_refused(flax_params):
    params = _to_dict(flax_params)
    params["shared_image_embedding"] = {"positional_embedding": params[
        "shared_image_embedding"]["positional_embedding"] + 1.0}
    with pytest.raises(ValueError, match="positional Gaussians"):
        flax_to_torch_state_dict(params)


def test_embeddings_masks_iou_match_flax(flax_params, port_model):
    cfg = JaxSamConfig.tiny()
    fm = JaxSamModel(cfg)
    variables = _flax_as_torch(flax_params)
    rng = np.random.default_rng(1)
    img = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    pts = rng.uniform(0, 64, (2, 3, 2, 2)).astype(np.float32)
    lbl = np.array([[[1, 0], [1, -1], [0, 1]], [[-1, -1], [1, 1], [1, 0]]], np.int32)

    emb_f = np.array(fm.apply(variables, jnp.asarray(img),
                                method=fm.get_image_embeddings))
    masks_f, iou_f = fm.apply(variables, jnp.asarray(emb_f), jnp.asarray(pts),
                              jnp.asarray(lbl), None, True, method=fm.predict_masks)
    with torch.no_grad():
        emb_t = port_model.get_image_embeddings(
            torch.from_numpy(img).permute(0, 3, 1, 2))
        masks_t, iou_t = port_model.predict_masks(
            torch.from_numpy(emb_f), torch.from_numpy(pts),
            torch.from_numpy(lbl).long())
    # measured: embeddings 5.3e-7, masks 1.6e-5, iou 2.8e-7 of their scale
    assert emb_t.shape == emb_f.shape
    assert _rel_err(emb_t, emb_f) < 1e-4
    assert masks_t.shape == masks_f.shape and iou_t.shape == iou_f.shape
    assert _rel_err(masks_t, masks_f) < 1e-4
    assert _rel_err(iou_t, iou_f) < 1e-4


def test_predictor_matches_flax(flax_params):
    cfg = JaxSamConfig.tiny()
    jp = JaxSamPredictor(cfg, _flax_as_torch(flax_params))
    tp = SamPredictor(SamConfig.tiny(), flax_to_torch_state_dict(flax_params),
                      device="cpu")
    _gelu(tp._ensure_model())
    rng = np.random.default_rng(2)
    # set_image: a 90x90 frame shrinks to the 64x64 input
    img = rng.integers(0, 256, (90, 90, 3)).astype(np.uint8)
    feats_f = np.array(jp.set_image(img))
    feats_t = tp.set_image(img).numpy()
    assert _rel_err(feats_t, feats_f) < 1e-4  # measured 7.9e-7

    # set_features (a cached channel-first embedding) + predict
    jp.set_features(np.transpose(feats_f, (0, 3, 1, 2)), (40, 40))
    tp.set_features(np.transpose(feats_f, (0, 3, 1, 2)), (40, 40))
    one = rng.uniform(1, 40, (3, 1, 2)).astype(np.float32)
    m_f, i_f, _ = jp.predict(one, np.ones((3, 1), np.int32))
    m_t, i_t, _ = tp.predict(one, np.ones((3, 1), np.int32))
    assert m_t.shape == m_f.shape == (3, 3, 40, 40)
    assert (m_t == m_f).mean() >= 0.999  # measured: 1.0
    assert _rel_err(i_t, i_f) < 1e-4  # measured 5.0e-7

    # predict_batch on the same features: 40x40 frames (the postprocess
    # grows 16 -> 64, then shrinks 64 -> 40), 8 prompts with pad prompts
    F_, P = 2, 8
    feats = np.concatenate([feats_f, feats_f[:, ::-1]], 0)
    pts = rng.uniform(1, 40, (F_, P, 1, 2)).astype(np.float32)
    lbl = np.ones((F_, P, 1), np.int32)
    lbl[1, 5:] = -1
    masks_f, iou_f = jp.predict_batch(feats, pts, lbl, (40, 40), mask_index=0)
    masks_t, iou_t = tp.predict_batch(feats, pts, lbl, (40, 40), mask_index=0)
    assert masks_t.shape == masks_f.shape == (F_, P, 1, 40, 40)
    assert masks_t.dtype == np.bool_
    assert _rel_err(iou_t, iou_f) < 1e-4  # measured 4.5e-7
    agree = (masks_t == masks_f).mean()
    assert agree >= 0.999, agree  # measured: 1.0
    if agree < 1.0:
        # every pixel that differs lies within 1e-3 of the mask threshold
        low, _ = jp._predict_fn(jp.params, jnp.asarray(feats),
                                jnp.asarray(jp._transform_points(pts)),
                                jnp.asarray(lbl))
        logits = np.stack([np.asarray(jp._postprocess(lr[:, :1])) for lr in low])
        assert np.abs(logits[masks_t != masks_f]).max() < 1e-3


@pytest.mark.parametrize("shape,size", [
    ((3, 1080, 1080), (1024, 1024)),  # _preprocess of a 1080^2 frame
    ((2, 1, 1024, 1024), (512, 512)),  # _postprocess to a 512^2 frame
    ((2, 1, 256, 256), (1024, 1024)),  # _postprocess's growing resize
])
def test_resize_matches_jax_image_resize(shape, size):
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), shape[:-2] + size, "linear"))
    got = resize_linear(torch.from_numpy(x), size).numpy()
    # measured: 4.8e-7, 2.4e-7 and 4.8e-7
    assert np.abs(got - want).max() < 1e-5


def test_build_sam_is_deterministic_and_finite():
    a = build_sam(SamConfig.tiny(), seed=3, device="cpu").state_dict()
    b = build_sam(SamConfig.tiny(), seed=3, device="cpu").state_dict()
    c = build_sam(SamConfig.tiny(), seed=4, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    assert all(torch.isfinite(v).all() for v in a.values())


def test_hf_state_dict_loads_by_official_names():
    """A HuggingFace SamModel state dict renames onto every official key of
    the port's model, and the port (official ReLU decoder, torch
    ConvTranspose2d) computes HF's masks from it."""
    os.environ.setdefault("USE_TF", "0")  # the torch model only
    transformers = pytest.importorskip("transformers")
    from transformers.models.sam import configuration_sam as C

    vc = C.SamVisionConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        image_size=64, patch_size=8, global_attn_indexes=[1], window_size=2,
        output_channels=16, num_pos_feats=8)
    pc = C.SamPromptEncoderConfig(hidden_size=16, image_embedding_size=8,
                                  image_size=64, patch_size=8,
                                  mask_input_channels=8)
    mc = C.SamMaskDecoderConfig(hidden_size=16, num_attention_heads=2,
                                mlp_dim=32, iou_head_hidden_dim=16)
    torch.manual_seed(0)
    hf = transformers.SamModel(transformers.SamConfig(
        vision_config=vc.to_dict(), prompt_encoder_config=pc.to_dict(),
        mask_decoder_config=mc.to_dict(), attn_implementation="eager")).eval()
    with torch.no_grad():
        for p in hf.parameters():  # weights of a visible scale
            p.normal_(0.0, 0.3)
    sd = convert_hf_state_dict(hf.state_dict())
    model = SamModel(SamConfig.tiny())
    model.load_state_dict(sd, strict=True)
    model.eval()
    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.standard_normal((1, 3, 64, 64)).astype(np.float32))
    pts = torch.from_numpy(rng.uniform(0, 64, (1, 2, 1, 2)).astype(np.float32))
    lbl = torch.ones((1, 2, 1), dtype=torch.int64)
    with torch.no_grad():
        ref = hf(pixel_values=img, input_points=pts, input_labels=lbl,
                 multimask_output=True)
        masks, iou = model(img, pts, lbl)
    # measured: masks 4.6e-6, iou 3.8e-6 of scale
    assert _rel_err(masks, ref.pred_masks) < 1e-4
    assert _rel_err(iou, ref.iou_scores) < 1e-4
