from .test import TEST, SemSegTester, load_weights
from .train import Trainer
from .defaults import default_argument_parser, default_config_parser
