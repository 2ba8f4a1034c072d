from .builder import DATASETS, build_dataset
from .transform import TRANSFORMS, Compose
from .collate import collate_fn, point_collate_fn
from .defaults import DefaultDataset, load_scene
from . import s3dis, scannet  # noqa: F401
