from .builder import DATASETS, build_dataset
from .transform import TRANSFORMS, Compose
from .collate import collate_fn
from .defaults import DefaultDataset, load_scene
from . import s3dis  # noqa: F401
