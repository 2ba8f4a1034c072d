from .builder import MODELS, build_model
from .losses import LOSSES, build_criteria
from . import default  # noqa: F401
from .point_transformer import ptv1  # noqa: F401
from .point_transformer_v2 import ptv2m2  # noqa: F401
from . import sparse_unet  # noqa: F401
from .context_aware_classifier import cac  # noqa: F401
from .point_group import point_group  # noqa: F401
from .masked_scene_contrast import msc  # noqa: F401
from . import swin3d  # noqa: F401
from .stratified_transformer import stratified  # noqa: F401
from .octformer import octformer  # noqa: F401
