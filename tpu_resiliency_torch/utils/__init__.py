from tpu_resiliency_torch.utils.logging import RankLoggerAdapter, get_logger

__all__ = ["get_logger", "RankLoggerAdapter"]
