"""The port's incident engine and its report CLI, held against
``tests/launcher/test_incident.py``: each of its tests runs here on
``tpu_resiliency_torch`` (``torch_port_tests``), the kill -9 run on the port's launcher
with ``--incidents-dir``, and the full loop on the port's store, restart coordinator,
policy and remediation engine. No edit; no test is left out.
"""

import pytest

from tests.torch_port_tests import port_tests


@pytest.fixture
def kv_server():
    from tpu_resiliency_torch.platform.store import KVServer

    server = KVServer(host="127.0.0.1", port=0)
    yield server
    server.close()


@pytest.fixture
def coord_store(kv_server):
    from tpu_resiliency_torch.platform.store import CoordStore

    store = CoordStore("127.0.0.1", kv_server.port, timeout=30.0)
    yield store
    store.close()


port_tests("tests/launcher/test_incident.py", globals())
