from .test import TEST, SemSegTester, load_weights
from .train import Trainer, TrainerBase
from .train_insseg import InsSegTrainer
from .hooks import HOOKS, HookBase, build_hooks
from .defaults import default_argument_parser, default_config_parser, launch_args
from .launch import launch, local_device
