"""The model families the framework exercises: the dense Llama-style transformer
(``transformer``, with the ``Transformer`` module) and the mixture of experts (``moe``,
with the ``MoE`` module: capacity-bound dispatch, or dropless grouped experts without a
capacity factor), in PyTorch; beyond the JAX package's families, the LFM2-style hybrid
of gated short convs and GQA attention over dense and dropless routed FFNs
(``models.hybrid``, with the ``Hybrid`` module). The exported names are the JAX
package's."""

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
