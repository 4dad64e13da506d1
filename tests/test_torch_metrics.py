"""The port's metrics family, held against ``tests/utils/test_metrics.py``,
``test_metrics_doc.py``, ``test_metrics_merge.py``, ``test_timeseries.py`` and
``test_byteflow.py``: each of their tests runs here on ``tpu_resiliency_torch.utils``
(``torch_port_tests``): the registry, the events bridge and its environment wiring, the
snapshot merge, the time-series rings and the byte-flow ledger. The one edit: the doc
test finds the repo root one directory up from this file, where the reference's file
lies two down; the metric names it reads from the port's ``utils/metrics.py`` must
stand in the reference's ``docs/observability.md`` as they are one registry. No test
is left out.
"""

from tests.torch_port_tests import port_tests

port_tests("tests/utils/test_metrics.py", globals())
port_tests("tests/utils/test_metrics_doc.py", globals(), edits=[(
    "REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))",
    "REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))",
    "this file lies in tests/, the reference's in tests/utils/")])
port_tests("tests/utils/test_metrics_merge.py", globals())
port_tests("tests/utils/test_timeseries.py", globals())
port_tests("tests/utils/test_byteflow.py", globals())
