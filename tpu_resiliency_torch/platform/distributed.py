"""torch.distributed lifecycle for resilient jobs: initialize survivable, tear down
restartable, re-initialize with a new world.

Port of ``tpu_resiliency/platform/distributed.py``, which drives ``jax.distributed``;
here the process group of ``torch.distributed`` takes its place, with the same names
and contracts:

- :func:`client_active` is ``dist.is_initialized()``.
- :func:`initialize` builds the default group: NCCL on the card, gloo on the CPU.
  ``recoverable`` is the counterpart of ``jax_enable_recoverability``: it sets
  ``TORCH_NCCL_ASYNC_ERROR_HANDLING=2`` (``CleanUpOnly``) before the group exists.
  After a collective timed out on an H100 with torch 2.11, the process outlived the
  timeout with every value; with 1 and 3 (the default) it then died by SIGABRT
  inside the teardown (:func:`shutdown_for_restart`), while with 0 and 2 the
  teardown returned, once the watchdog had handled the timeout, and the process
  lived on. Of those two, 2 has the watchdog abort the failed
  communicator itself, which ends a collective that waits on a dead peer and so
  releases a thread parked on it; 0 leaves the communicator as it is until the
  caller's own abort, which a parked main thread never reaches. That difference is
  reasoned from the documented modes, not measured. ``chip_smoke.py``'s
  ``restart_path`` part (d) times out a collective under the Wrapper and checks
  that the rank lives through the abort and re-enters in a new group.
- :func:`shutdown_for_restart` aborts the NCCL communicators of every group, then
  destroys the groups, so a later :func:`initialize` with another world is legal.
  It never raises.
- :func:`shutdown_ordered` and :func:`shutdown_graceful` keep the reference's
  end-of-job protocol: the rank that hosts the rendezvous (active rank 0, whose
  ``tcp://`` init method runs the TCP store) tears down last.
- :func:`reserve_port` gives a parent the port its children meet on, held until they
  have bound it.

The reference's ``clear_backends`` has no torch counterpart: a process group holds
no compiled programs or device buffers that a re-initialize must drop, and
``init_process_group`` refuses only while a default group exists, which
:func:`shutdown_for_restart` destroys.

A collective already in flight against a dead peer can still block (gloo has no
liveness timeout, NCCL's watchdog fires only after the group's ``timeout``); that
case is the monitor process's hard-timeout ladder (``inprocess/monitor_process.py``),
not this module's.
"""

from __future__ import annotations

import datetime
import os
import socket
import time

import torch

from tpu_resiliency_torch.platform.device import resolve_device
from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)

#: The value of ``TORCH_NCCL_ASYNC_ERROR_HANDLING`` that :func:`initialize` sets
#: when ``recoverable``: ``CleanUpOnly``, abort the failed communicators and keep
#: the process.
RECOVERABLE_NCCL_ERROR_HANDLING = "2"

#: How :func:`shutdown_for_restart` last aborted NCCL communicators:
#: ``"backend.abort"``, ``"_abort_process_group"``, or ``None`` when no NCCL group
#: was live.
last_abort_method: str | None = None


def reserve_port(host: str = "127.0.0.1") -> tuple[int, socket.socket]:
    """A free TCP port on ``host``, and the socket that holds it.

    The socket is bound with ``SO_REUSEADDR`` and never listens. On Linux the process
    that serves the port may still bind it and listen, if it also sets
    ``SO_REUSEADDR``: a ``KVServer`` and rank 0's ``TCPStore`` of a ``tcp://``
    init method both do. Meanwhile the kernel hands the port to no other
    ``bind(("", 0))`` and no outgoing connection. Keep the socket open until the
    server has bound the port (the job's end is simplest), then close it.

    A port found by binding a socket and closing it again is free to anyone until the
    server binds it: under load another process took it first, and children failed to
    bind it or met on another job's store."""
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind((host, 0))
    return s.getsockname()[1], s


def client_active() -> bool:
    """Is a default process group currently initialized?"""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def initialize(
    init_method: str,
    world_size: int,
    rank: int,
    *,
    backend: str | None = None,
    timeout: float = 60.0,
    recoverable: bool = True,
    device=None,
) -> None:
    """``torch.distributed.init_process_group`` with survivable defaults.

    ``device=None`` means the card (raises without one): the group is NCCL, bound to
    the card, and its communicator is created here. ``device="cpu"`` gives gloo.
    ``backend`` overrides the choice. ``recoverable`` sets
    ``TORCH_NCCL_ASYNC_ERROR_HANDLING`` to :data:`RECOVERABLE_NCCL_ERROR_HANDLING`
    before the group exists, so a failed or timed-out communicator surfaces as an
    error instead of terminating this process; set it False only for jobs that
    prefer fail-fast semantics.
    """
    import torch.distributed as dist

    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if recoverable:
        old = os.environ.get("TORCH_NCCL_ASYNC_ERROR_HANDLING")
        if old not in (None, RECOVERABLE_NCCL_ERROR_HANDLING):
            log.warning(
                f"TORCH_NCCL_ASYNC_ERROR_HANDLING={old} overridden with "
                f"{RECOVERABLE_NCCL_ERROR_HANDLING}: a recoverable group keeps the process"
            )
        os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = RECOVERABLE_NCCL_ERROR_HANDLING
    kwargs = {}
    if backend == "nccl":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    dist.init_process_group(
        backend,
        init_method=init_method,
        world_size=world_size,
        rank=rank,
        timeout=datetime.timedelta(seconds=timeout),
        **kwargs,
    )
    log.info(
        f"torch.distributed initialized: backend={backend} world={world_size} rank={rank} "
        f"init_method={init_method} recoverable={recoverable}"
    )


def _nccl_backend(pg):
    """The NCCL backend of process group ``pg``, or None."""
    import torch.distributed as dist

    if dist.get_backend(pg) != "nccl":
        return None
    try:
        return pg._get_backend(torch.device("cuda"))  # noqa: SLF001
    except RuntimeError:
        return None


def _abort_communicators() -> str | None:
    """Abort the NCCL communicators of every live group, newest first; returns the
    method used. The backend's ``abort()`` where the installed torch has it, else
    ``distributed_c10d._abort_process_group``, which also drops every group."""
    from torch.distributed import distributed_c10d as c10d

    groups = sorted(c10d._world.pg_names, key=lambda g: c10d._world.pg_names[g],  # noqa: SLF001
                    reverse=True)
    backends = [b for b in map(_nccl_backend, groups) if b is not None]
    if not backends:
        return None
    if all(hasattr(b, "abort") for b in backends):
        for b in backends:
            b.abort()
        return "backend.abort"
    c10d._abort_process_group()  # noqa: SLF001
    return "_abort_process_group"


def shutdown_for_restart() -> bool:
    """Abort the NCCL communicators of every group, then destroy the groups, so a
    later :func:`initialize` with a different world is legal.

    Returns True when a process group was torn down. Never raises: the restart loop
    must proceed no matter how broken the old world's state is.
    """
    global last_abort_method
    if not client_active():
        return False
    import torch.distributed as dist

    try:
        last_abort_method = _abort_communicators()
        if last_abort_method is not None:
            log.info(f"NCCL communicators aborted ({last_abort_method})")
    except Exception as e:
        log.warning(f"NCCL communicator abort failed (continuing): {e!r}")
    try:
        if dist.is_initialized():
            dist.destroy_process_group()
        log.info("torch.distributed process groups destroyed for re-initialize")
    except Exception as e:
        log.warning(f"destroy_process_group failed (continuing): {e!r}")
    return True


def shutdown_ordered(
    store,
    active_rank: int,
    active_world_size: int,
    *,
    iteration: int = 0,
    timeout: float = 30.0,
    key: str = "jd_shutdown_done",
) -> None:
    """Orderly END-OF-JOB teardown: the rank hosting the rendezvous outlives every
    peer.

    Non-coordinator ranks destroy their groups first and announce on the job
    ``store``; the coordinator (active rank 0) waits for every announcement (bounded
    by ``timeout``, best-effort beyond it) before destroying its own. Call once per
    rank after the last collective, passing the restart ``iteration`` (stale
    announcements from an earlier, fault-aborted completion attempt must not satisfy
    this round's wait). Never raises: a completed job must not be re-classified as
    faulted because its teardown hiccuped.
    """
    import torch.distributed as dist

    if not client_active():
        return
    skey = f"{key}/{iteration}"
    if active_rank != 0:
        try:
            dist.destroy_process_group()
        except Exception as e:
            log.warning(f"shutdown_ordered: group teardown failed: {e!r}")
        try:
            store.set_add(skey, [int(active_rank)])
        except Exception as e:
            log.warning(f"shutdown_ordered: announcement failed: {e!r}")
        return
    expected = set(range(1, active_world_size))
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline:
            if set(store.set_get(skey)) >= expected:
                break
            time.sleep(0.05)
        else:
            log.warning(
                f"shutdown_ordered: peers {expected - set(store.set_get(skey))} "
                f"never announced their teardown within {timeout}s; tearing down anyway"
            )
    except Exception as e:
        log.warning(f"shutdown_ordered: announcement wait failed: {e!r}")
    try:
        dist.destroy_process_group()
    except Exception as e:
        log.warning(f"shutdown_ordered: coordinator teardown failed: {e!r}")


def shutdown_graceful(process_id: int, grace: float = 5.0) -> None:
    """End-of-job teardown WITHOUT a coordination store: non-coordinator ranks tear
    down immediately; the coordinator idles ``grace`` seconds first, so a peer's
    slightly-later teardown still finds the rendezvous up (see
    :func:`shutdown_ordered`, which is deterministic and preferred when a KV store
    is available). Never raises."""
    import torch.distributed as dist

    if not client_active():
        return
    try:
        if process_id == 0 and dist.get_world_size() > 1:
            time.sleep(grace)
        dist.destroy_process_group()
    except Exception as e:
        log.warning(f"shutdown_graceful: {e!r}")
