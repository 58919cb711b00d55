from .base import ModelConfig, TrainConfig, reduced
from .registry import ARCHS, get_arch
