"""Parallelism package: the mesh axis conventions and sharding-spec helpers
(``mesh``). Ring attention and the pipeline schedule are not ported yet (see
ROADMAP.md)."""

from tpu_resiliency_torch.parallel import mesh

__all__ = ["mesh"]
