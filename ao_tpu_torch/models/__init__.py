from .builder import MODELS, build_model
from .losses import LOSSES, build_criteria
from . import default  # noqa: F401
from .point_transformer_v2 import ptv2m2  # noqa: F401
from . import sparse_unet  # noqa: F401
