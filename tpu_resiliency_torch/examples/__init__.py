"""The port's examples: the launcher's worker scripts ``resilient_training`` and
``layered_restart``, and the repo-root examples ``preemption_train``,
``moe_pipeline_training``, ``inprocess_restart_train`` and
``mesh_telemetry_training``."""
