"""Worker scripts for the port's launcher: ``resilient_training`` and ``layered_restart``."""
