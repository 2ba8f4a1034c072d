from .ptv2m2 import PointTransformerV2
from .convert import from_jax_variables, load_jax_npz
