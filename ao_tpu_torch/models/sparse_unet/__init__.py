from .spunet import SpUNet
from .mink_spvcnn import SPVCNN
from .convert import from_jax_variables
