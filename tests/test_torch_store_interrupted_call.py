"""A store call interrupted between its request and its reply, as the in-process
Wrapper's restart signal (``PyThreadState_SetAsyncExc``) interrupts a rank polling the
store, must leave nothing behind for the next call on the persistent socket.

``platform/store.py`` is a copy of the reference's; it drops the socket on such an
exception (``tests/test_torch_support_copies.py`` lists the edit). Before, the next
call read the interrupted call's reply as its own: in
``examples/moe_pipeline_training.py`` under load, rank 0's ``job_done`` read a peer list
(truthy) and stood down mid-restart, and its store went with it.
"""

import pytest

from tpu_resiliency_torch.platform import framing
from tpu_resiliency_torch.platform.store import CoordStore, KVServer


class Signal(BaseException):
    """Stands in for the Wrapper's ``RankShouldRestart``, raised into the thread."""


@pytest.fixture
def client():
    server = KVServer(host="127.0.0.1", port=0)
    store = CoordStore("127.0.0.1", server.port, timeout=10.0)
    yield store
    store.close()
    server.close()


def test_the_next_call_reads_its_own_reply(client, monkeypatch):
    client.set_add("peers", [0, 1, 2])
    recv = framing.recv_obj

    def interrupted(*a, **kw):
        monkeypatch.setattr(framing, "recv_obj", recv)
        raise Signal  # the request went out; its reply was never read

    monkeypatch.setattr(framing, "recv_obj", interrupted)
    with pytest.raises(Signal):
        client.set_get("peers")
    assert client.try_get("job_done", False) is False
    assert sorted(client.set_get("peers")) == [0, 1, 2]
