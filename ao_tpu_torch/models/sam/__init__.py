from .modeling import SamConfig, SamModel, build_sam
from .convert import (
    convert_hf_state_dict,
    flax_to_torch_state_dict,
    load_sam_checkpoint,
)
from .oracle import OracleSamPredictor
from .predictor import SamPredictor
