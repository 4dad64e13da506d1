"""Command-line measurements of the port (``python -m tpu_resiliency_torch.scripts.<name>``)."""
