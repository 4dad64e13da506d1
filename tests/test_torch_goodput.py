"""The port's goodput ledger, held against ``tests/utils/test_goodput.py`` and
``tests/launcher/test_goodput_e2e.py``: each of their tests runs here on
``tpu_resiliency_torch`` (``torch_port_tests``), the end-to-end one on the port's
launcher with ``--telemetry-port``, its ``/goodput`` endpoint and
``python -m tpu_resiliency_torch.tools.metrics_dump --goodput`` over the same events
file (phases summing to the wall clock within 5%). No edit; no test is left out.
"""

from tests.torch_port_tests import port_tests

port_tests("tests/utils/test_goodput.py", globals())
port_tests("tests/launcher/test_goodput_e2e.py", globals())
