"""The model families the framework exercises: the dense Llama-style transformer
(``transformer``, with the ``Transformer`` module) and the mixture of experts
(``moe``, with the ``MoE`` module), in PyTorch."""

from tpu_resiliency_torch.models import moe
from tpu_resiliency_torch.models.moe import MoEConfig
from tpu_resiliency_torch.models.transformer import (
    TransformerConfig,
    forward,
    init_params,
    loss_fn,
    make_train_step,
)

__all__ = [
    "MoEConfig",
    "TransformerConfig",
    "forward",
    "init_params",
    "loss_fn",
    "make_train_step",
    "moe",
]
