from .registry import Registry, build_from_cfg
from .config import Config, ConfigDict, DictAction
from .logger import get_root_logger
from .events import AverageMeter, EventStorage, TensorboardWriter
from .misc import intersection_and_union
