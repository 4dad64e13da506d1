"""moe.experts_ms: the median, over the window's steps, of the device milliseconds of the
program's ``moe.experts`` spans in the step (the routed layers' grouped products,
forward and backward, summed; from the span ring of
``tpu_resiliency_torch/utils/tracing.py``). A run whose trace saw no device, or a
program without such spans, reads nothing."""

from benchmark import program_spans


def read(ctx):
    return program_spans.device_ms_per_step(ctx, "moe.experts")
