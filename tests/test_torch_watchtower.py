"""The port's SLO watchtower, held against ``tests/telemetry/test_watchtower.py``: each of
its tests runs here on ``tpu_resiliency_torch.telemetry.watchtower`` and
``tools/alerts_cli.py`` (``torch_port_tests``). No edit; no test is left out.
``test_watchtower_perf.py`` is the reference's slow timing gate and does not run here.
"""

from tests.torch_port_tests import port_tests

port_tests("tests/telemetry/test_watchtower.py", globals())
