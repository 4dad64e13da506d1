"""The port's metrics and timeline CLIs, held against ``tests/utils/test_metrics_dump.py``
and ``test_events_summary.py``: each of their tests runs here on
``tpu_resiliency_torch.tools`` (``torch_port_tests``), the piped ones as
``python -m tpu_resiliency_torch.tools.events_summary``. No edit; no test is left out.
"""

from tests.torch_port_tests import port_tests

port_tests("tests/utils/test_metrics_dump.py", globals())
port_tests("tests/utils/test_events_summary.py", globals())
