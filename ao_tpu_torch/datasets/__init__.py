from .builder import DATASETS, build_dataset
from .transform import TRANSFORMS, Compose
from .collate import collate_fn, point_collate_fn
from .defaults import DefaultDataset, load_scene
from . import misc_datasets, nuscenes, s3dis, scannet, semantic_kitti  # noqa: F401
