from .builder import DATASETS, build_dataset
from .transform import TRANSFORMS, Compose
from .collate import collate_fn, point_collate_fn
from .defaults import ConcatDataset, DefaultDataset, load_scene
from . import misc_datasets, modelnet, nuscenes, s3dis, scannet, semantic_kitti, synthetic  # noqa: F401
