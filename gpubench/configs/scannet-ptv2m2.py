# PT-v2m2 ScanNet semantic segmentation as the benchmark runs it: the port's
# configs/scannet/semseg-pt-v2m2-0-base.py (Pointcept's
# configs/scannet/semseg-pt-v2m2-0-base.py with the port's static-shape keys:
# pad_multiple, max_points, stage_cap_ratios) and its base
# configs/_base_/default_runtime.py, copied into one file so that a later
# change to the repository's configs does not change what this cell runs.
# One change, listed in `reduced`: model.backbone.enable_checkpoint=True.
# Widths 48 / 96 / 192 / 384 / 512, the config's batch of 12, Mix3D at 0.8
# and its 100000-point crops. Precision departs from Pointcept's: its
# runtime trains under fp16 autocast (enable_amp=True), the port's config
# states no compute dtype and so runs in float32 (`assumed`).

# ---- configs/_base_/default_runtime.py ----
# Global runtime defaults (reference: configs/_base_/default_runtime.py)
weight = None  # checkpoint to load
resume = False  # resume training (epoch/optimizer state)
evaluate = True  # per-epoch evaluation
test_only = False

seed = None  # random if None
save_path = "exp/default"
num_worker = 8  # data-prep worker threads (total across processes)
batch_size = 16  # GLOBAL batch size (sharded over the data mesh axis)
batch_size_val = None
batch_size_test = None
epoch = 100  # total epochs (dataset loops epoch // eval_epoch per mega-epoch)
eval_epoch = 100  # number of mega-epochs (evaluation points)

# TPU batching: samples pad to a multiple of this (bounds compiled shapes)
pad_multiple = 4096
max_points = None  # hard cap on padded points per sample

mix_prob = 0
param_dicts = None

hooks = [
    dict(type="CheckpointLoader"),
    dict(type="IterationTimer", warmup_iter=2),
    dict(type="InformationWriter"),
    dict(type="SemSegEvaluator"),
    dict(type="CheckpointSaver", save_freq=None),
]

test = dict(type="SemSegTester", verbose=True)

# ---- configs/scannet/semseg-pt-v2m2-0-base.py ----

batch_size = 12
mix_prob = 0.8
seed = 2023
pad_multiple = 8192
max_points = 102400
save_path = "exp/scannet/semseg-pt-v2m2-0-base"

model = dict(
    type="DefaultSegmentor",
    backbone=dict(
        type="PT-v2m2",
        in_channels=9,
        num_classes=20,
        patch_embed_depth=1,
        patch_embed_channels=48,
        patch_embed_groups=6,
        patch_embed_neighbours=8,
        enc_depths=(2, 2, 6, 2),
        enc_channels=(96, 192, 384, 512),
        enc_groups=(12, 24, 48, 64),
        enc_neighbours=(16, 16, 16, 16),
        dec_depths=(1, 1, 1, 1),
        dec_channels=(48, 96, 192, 384),
        dec_groups=(6, 12, 24, 48),
        dec_neighbours=(16, 16, 16, 16),
        grid_sizes=(0.06, 0.15, 0.375, 0.9375),
        attn_qkv_bias=True,
        pe_multiplier=False,
        pe_bias=True,
        attn_drop_rate=0.0,
        drop_path_rate=0.3,
        unpool_backend="map",
        # the one change from the source: recompute each block in the
        # backward, the least change that fits the batch of 12 on one card
        enable_checkpoint=True,
        stage_cap_ratios=(0.35, 0.35, 0.35, 0.35),
    ),
    criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)],
)

epoch = 900
eval_epoch = 100
optimizer = dict(type="AdamW", lr=0.005, weight_decay=0.02)
scheduler = dict(type="OneCycleLR", max_lr=0.005, pct_start=0.05,
                 anneal_strategy="cos", div_factor=10.0, final_div_factor=10000.0)

dataset_type = "ScanNetDataset"
data_root = "data/scannet"

names = [
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refridgerator", "shower curtain", "toilet", "sink", "bathtub",
    "otherfurniture",
]

_train_transform = [
    dict(type="CenterShift", apply_z=True),
    dict(type="RandomDropout", dropout_ratio=0.2, dropout_application_ratio=0.2),
    dict(type="RandomRotate", angle=[-1, 1], axis="z", center=[0, 0, 0], p=0.5),
    dict(type="RandomRotate", angle=[-1 / 64, 1 / 64], axis="x", p=0.5),
    dict(type="RandomRotate", angle=[-1 / 64, 1 / 64], axis="y", p=0.5),
    dict(type="RandomScale", scale=[0.9, 1.1]),
    dict(type="RandomFlip", p=0.5),
    dict(type="RandomJitter", sigma=0.005, clip=0.02),
    dict(type="ElasticDistortion", distortion_params=[[0.2, 0.4], [0.8, 1.6]]),
    dict(type="ChromaticAutoContrast", p=0.2, blend_factor=None),
    dict(type="ChromaticTranslation", p=0.95, ratio=0.05),
    dict(type="ChromaticJitter", p=0.95, std=0.05),
    dict(type="GridSample", grid_size=0.02, hash_type="fnv", mode="train",
         keys=("coord", "color", "normal", "segment"),
         return_discrete_coord=True),
    dict(type="SphereCrop", point_max=100000, mode="random"),
    dict(type="CenterShift", apply_z=False),
    dict(type="NormalizeColor"),
    dict(type="ToTensor"),
    dict(type="Collect", keys=("coord", "discrete_coord", "segment"),
         feat_keys=("coord", "color", "normal")),
]

data = dict(
    num_classes=20,
    ignore_index=-1,
    names=names,
    train=dict(type=dataset_type, split="train", data_root=data_root,
               transform=_train_transform, test_mode=False),
    val=dict(
        type=dataset_type, split="val", data_root=data_root,
        transform=[
            dict(type="CenterShift", apply_z=True),
            dict(type="Copy",
                 keys_dict={"coord": "origin_coord", "segment": "origin_segment"}),
            dict(type="GridSample", grid_size=0.02, hash_type="fnv",
                 mode="train", keys=("coord", "color", "normal", "segment"),
                 return_discrete_coord=True),
            dict(type="CenterShift", apply_z=False),
            dict(type="NormalizeColor"),
            dict(type="ToTensor"),
            dict(type="Collect", keys=("coord", "discrete_coord", "segment"),
                 feat_keys=("coord", "color", "normal")),
        ],
        test_mode=False,
    ),
    test=dict(
        type=dataset_type, split="val", data_root=data_root,
        transform=[dict(type="CenterShift", apply_z=True),
                   dict(type="NormalizeColor")],
        test_mode=True,
        test_cfg=dict(
            voxelize=dict(type="GridSample", grid_size=0.02, hash_type="fnv",
                          mode="test", keys=("coord", "color", "normal"),
                          return_discrete_coord=True),
            crop=None,
            post_transform=[
                dict(type="CenterShift", apply_z=False),
                dict(type="ToTensor"),
                dict(type="Collect", keys=("coord", "discrete_coord", "index"),
                     feat_keys=("coord", "color", "normal")),
            ],
            aug_transform=[
                [dict(type="RandomScale", scale=[s, s], anisotropic=True)]
                for s in (0.9, 0.95, 1.0, 1.05, 1.1)
            ] + [
                [dict(type="RandomScale", scale=[s, s], anisotropic=True),
                 dict(type="RandomFlip", p=1)]
                for s in (0.9, 0.95, 1.0, 1.05, 1.1)
            ],
        ),
    ),
)

# ---- the benchmark's description of this configuration (the port ignores
# keys it does not know) ----
bench = dict(
    source="https://github.com/Pointcept/Pointcept/blob/main/configs/scannet/semseg-pt-v2m2-0-base.py",
    reduced=["model.backbone.enable_checkpoint"],
    assumed=[
        "enable_checkpoint=True: without it the config's B=12 in f32 does "
        "not fit one 80 GB card",
        "pad_multiple=8192, max_points=102400, stage_cap_ratios=0.35: the "
        "port's static shapes (100000-point crops pad to 102400)",
        "float32: Pointcept trains this config under fp16 autocast "
        "(enable_amp=True); the port's config states no compute_dtype, so "
        "its attention runs unfused in float32, as the port runs it",
        "traffic: 12 synthetic rooms of the S3DIS-like office / hallway / "
        "conference-room mix (ScanNet's layout of features), not ScanNet's "
        "scene-type mix, which needs the release's scene list",
    ],
    family="ptv2m2",
    # the control of the correctness check: one precision below the stated
    control="tf32",
    # f32 as written; mfu takes the TF32 peak where the run finds TF32 on
    precision="f32",
)
