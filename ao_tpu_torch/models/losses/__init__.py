from .builder import LOSSES, Criteria, build_criteria
from . import misc  # noqa: F401
