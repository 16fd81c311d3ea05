"""Models of the PyTorch port."""

from .deepseek_v3 import DeepseekV3Config, DeepseekV3LM
from .inception import InceptionV3
from .layers import from_flax_variables
from .resnet import ResNet, ResNet18, ResNet34, ResNet50, ResNet101, ResNet152
from .sync_batch_norm import BatchNorm, SyncBatchNorm
from .transformer import (TransformerConfig, TransformerLM, from_flax_params,
                          lm_loss)
from .vgg import VGG, VGG16, VGG19

__all__ = [
    "ResNet", "ResNet18", "ResNet34", "ResNet50", "ResNet101", "ResNet152",
    "VGG", "VGG16", "VGG19", "InceptionV3", "BatchNorm", "SyncBatchNorm",
    "TransformerConfig", "TransformerLM", "DeepseekV3Config", "DeepseekV3LM",
    "from_flax_params",
    "from_flax_variables", "lm_loss",
]
