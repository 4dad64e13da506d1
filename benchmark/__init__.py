"""The benchmark of the PyTorch and CUDA port (``tpu_resiliency_torch``): its harness,
its traffic, its plain references and its frozen arithmetic. ``python3 -m
benchmark.run --help`` runs one cell; ``BENCHMARK.json`` at the checkout's root lists
the cells and metrics."""
