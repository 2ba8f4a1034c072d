# PT-v2m2 S3DIS semantic segmentation as the benchmark runs it: the port's
# configs/s3dis/semseg-pt-v2m2-0-base.py, which is AO's
# configs/s3dis/semseg-pt-v2m2-0-base.py (github.com/jihun1998/AO, the
# backbone AO trains: 3 encoder stages 96 / 192 / 384, patch embedding of
# depth 2 with 16 neighbours, pooling grids 0.1 / 0.2 / 0.4, interpolation
# unpooling, GridSample 0.04, no Mix3D, MultiStepLR at 0.09 / 0.2) with the
# port's static-shape keys (pad_multiple, max_points, stage_cap_ratios,
# compute_dtype), and its base configs/_base_/default_runtime.py, copied
# into one file so that a later change to the repository's configs does not
# change what this cell runs. Nothing of AO's file is cut: its batch of 12
# and its 80000-point crops. It is not Pointcept's S3DIS base, which has 4
# encoder stages, map unpooling, GridSample 0.02 and Mix3D.

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

# ---- configs/s3dis/semseg-pt-v2m2-0-base.py ----

batch_size = 12  # global batch across the data mesh axis
mix_prob = 0
seed = 4242

model = dict(
    type="DefaultSegmentor",
    backbone=dict(
        type="PT-v2m2",
        in_channels=6,
        num_classes=13,
        patch_embed_depth=2,
        patch_embed_channels=48,
        patch_embed_groups=6,
        patch_embed_neighbours=16,
        enc_depths=(2, 6, 2),
        enc_channels=(96, 192, 384),
        enc_groups=(12, 24, 48),
        enc_neighbours=(16, 16, 16),
        dec_depths=(1, 1, 1),
        dec_channels=(48, 96, 192),
        dec_groups=(6, 12, 24),
        dec_neighbours=(16, 16, 16),
        grid_sizes=(0.1, 0.2, 0.4),
        attn_qkv_bias=True,
        pe_multiplier=False,
        pe_bias=True,
        attn_drop_rate=0.0,
        drop_path_rate=0.3,
        enable_checkpoint=False,
        unpool_backend="interp",
        # static per-stage cluster capacity as a fraction of the previous
        # stage (S3DIS 0.04 m sample -> 0.1/0.2/0.4 m pooling reduces ~4-6x;
        # 0.35 leaves comfortable headroom)
        stage_cap_ratios=(0.35, 0.35, 0.35),
        # reference trains with AMP (enable_amp=True); bf16 is the TPU analog
        compute_dtype="bfloat16",
    ),
    criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)],
)

epoch = 3000
eval_epoch = 100
optimizer = dict(type="AdamW", lr=0.006, weight_decay=0.05)
scheduler = dict(type="MultiStepLR", milestones=[0.09, 0.2], gamma=0.1)

dataset_type = "S3DISDataset"
data_root = "data/s3dis"
pad_multiple = 8192
max_points = 81920

data = dict(
    num_classes=13,
    ignore_index=-1,
    names=[
        "ceiling", "floor", "wall", "beam", "column", "window", "door",
        "table", "chair", "sofa", "bookcase", "board", "clutter",
    ],
    train=dict(
        type=dataset_type,
        split=("Area_1", "Area_2", "Area_3", "Area_4", "Area_6"),
        data_root=data_root,
        transform=[
            dict(type="CenterShift", apply_z=True),
            dict(type="RandomScale", scale=[0.9, 1.1]),
            dict(type="RandomFlip", p=0.5),
            dict(type="RandomJitter", sigma=0.005, clip=0.02),
            dict(type="ChromaticAutoContrast", p=0.2, blend_factor=None),
            dict(type="ChromaticTranslation", p=0.95, ratio=0.05),
            dict(type="ChromaticJitter", p=0.95, std=0.05),
            dict(
                type="GridSample",
                grid_size=0.04,
                hash_type="fnv",
                mode="train",
                keys=("coord", "color", "segment"),
                return_discrete_coord=True,
            ),
            dict(type="SphereCrop", point_max=80000, mode="random"),
            dict(type="CenterShift", apply_z=False),
            dict(type="NormalizeColor"),
            dict(type="ToTensor"),
            dict(
                type="Collect",
                keys=("coord", "discrete_coord", "segment"),
                feat_keys=["coord", "color"],
            ),
        ],
        test_mode=False,
    ),
    val=dict(
        type=dataset_type,
        split="Area_5",
        data_root=data_root,
        transform=[
            dict(type="CenterShift", apply_z=True),
            dict(
                type="Copy",
                keys_dict={"coord": "origin_coord", "segment": "origin_segment"},
            ),
            dict(
                type="GridSample",
                grid_size=0.04,
                hash_type="fnv",
                mode="train",
                keys=("coord", "color", "segment"),
                return_discrete_coord=True,
            ),
            dict(type="CenterShift", apply_z=False),
            dict(type="NormalizeColor"),
            dict(type="ToTensor"),
            dict(
                type="Collect",
                keys=("coord", "discrete_coord", "segment"),
                feat_keys=["coord", "color"],
            ),
        ],
        test_mode=False,
    ),
    test=dict(
        type=dataset_type,
        split="Area_5",
        data_root=data_root,
        transform=[
            dict(type="CenterShift", apply_z=True),
            dict(type="NormalizeColor"),
        ],
        test_mode=True,
        test_cfg=dict(
            voxelize=dict(
                type="GridSample",
                grid_size=0.04,
                hash_type="fnv",
                mode="test",
                keys=("coord", "color"),
                return_discrete_coord=True,
            ),
            crop=None,
            post_transform=[
                dict(type="CenterShift", apply_z=False),
                dict(type="ToTensor"),
                dict(
                    type="Collect",
                    keys=("coord", "discrete_coord", "index"),
                    feat_keys=("coord", "color"),
                ),
            ],
            aug_transform=[
                [dict(type="RandomScale", scale=[0.9, 0.9], anisotropic=True)],
                [dict(type="RandomScale", scale=[0.95, 0.95], anisotropic=True)],
                [dict(type="RandomScale", scale=[1, 1], anisotropic=True)],
                [dict(type="RandomScale", scale=[1.05, 1.05], anisotropic=True)],
                [dict(type="RandomScale", scale=[1.1, 1.1], anisotropic=True)],
                [
                    dict(type="RandomScale", scale=[0.9, 0.9], anisotropic=True),
                    dict(type="RandomFlip", p=1),
                ],
                [
                    dict(type="RandomScale", scale=[0.95, 0.95], anisotropic=True),
                    dict(type="RandomFlip", p=1),
                ],
                [
                    dict(type="RandomScale", scale=[1, 1], anisotropic=True),
                    dict(type="RandomFlip", p=1),
                ],
                [
                    dict(type="RandomScale", scale=[1.05, 1.05], anisotropic=True),
                    dict(type="RandomFlip", p=1),
                ],
                [
                    dict(type="RandomScale", scale=[1.1, 1.1], anisotropic=True),
                    dict(type="RandomFlip", p=1),
                ],
            ],
        ),
    ),
)

# ---- the benchmark's description of this configuration (the port ignores
# keys it does not know) ----
bench = dict(
    source="https://github.com/jihun1998/AO/blob/HEAD/configs/s3dis/semseg-pt-v2m2-0-base.py",
    reduced=[],
    assumed=[
        "compute_dtype=bfloat16: the published config trains under fp16 "
        "autocast (enable_amp=True); the port computes the attention blocks "
        "in bf16",
        "pad_multiple=8192, max_points=81920, stage_cap_ratios=0.35: the "
        "port's static shapes (80000-point crops pad to 81920)",
    ],
    family="ptv2m2",
    # the control of the correctness check: one precision below the stated
    control="fp8",
    # peak of the stated compute precision for mfu (bf16 attention blocks)
    precision="bf16",
)
