"""The port's launcher telemetry server, held against
``tests/launcher/test_telemetry_server.py``: each of its tests runs here on
``tpu_resiliency_torch.launcher.telemetry`` (``torch_port_tests``): ``/metrics``,
``/goodput``, ``/healthz``, ``/hangz``, ``/incidents``, ``/snapshot``, ``/storez``,
``/alerts`` and ``/autoscale``, and the launcher's port-file handshake. No edit; no test
is left out.
"""

from tests.torch_port_tests import port_tests

port_tests("tests/launcher/test_telemetry_server.py", globals())
