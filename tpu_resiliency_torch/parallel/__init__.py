"""Parallelism package: the mesh axis conventions and sharding-spec helpers
(``mesh``). ``ring_attention`` and ``pipeline`` (with ``p2p``, their differentiable
neighbour exchanges) are not imported here, as the reference does not import its
``pipeline``: import them directly, ``from tpu_resiliency_torch.parallel import
pipeline``."""

from tpu_resiliency_torch.parallel import mesh

__all__ = ["mesh"]
