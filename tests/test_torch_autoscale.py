"""The port's remediation engine and autoscale controller, held against
``tests/telemetry/test_remediation.py`` and ``tests/launcher/test_autoscale.py``: each of
their tests runs here on ``tpu_resiliency_torch`` (``torch_port_tests``), the launcher
runs on the port's launcher with ``--autoscale``. No edit; no test is left out.
(``tests/launcher/test_chaos_e2e.py::test_autoscale_scenario_beats_baseline_and_reproduces``
fails in the reference, so it is no oracle and does not run here.)
"""

from tests.torch_port_tests import port_tests

port_tests("tests/telemetry/test_remediation.py", globals())
port_tests("tests/launcher/test_autoscale.py", globals())
