"""Fault injection for resiliency testing.

Port of ``tpu_resiliency/inprocess/tools/inject_fault.py``: a registry of fault kinds
that tests and examples trigger deterministically (by iteration/step) or after a
delay, exercising every detector: exceptions (monitor-thread path), async exceptions,
SIGKILL / segfault (sibling + monitor-process death paths), GIL lockup (progress
watchdog hard-timeout path), and sleeps (soft-timeout path). Those are copied.

The device faults are real on the card, through the hand-written kernels of
``csrc/faults.cu`` (built at first use by ``ops/_build.py``):

- ``DEVICE_HANG`` launches a kernel that never ends and waits for it: the calling
  thread parks in the CUDA driver with the GIL released, as the reference's parks in
  ``block_until_ready``. Only the monitor process's hard-timeout ladder gets the
  rank out, and the spinning kernel dies with its process's context.
- ``DEVICE_ERROR`` launches a kernel that executes ``__trap()``: the context takes a
  sticky error and every later CUDA call of the process fails, which the reference
  only simulates. No call can undo it: :func:`heal_device_error` raises on the card.

With ``device="cpu"`` (the tests here) the hang is a C-level wait with the GIL
released, and the error sets the CPU's dead-runtime mark
(``platform.device.set_cpu_runtime_dead``) that the liveness probe and
``CudaHealthCheck(device="cpu")`` honour and :func:`heal_device_error` clears.

Faults are destructive by design; they are for tests of THIS framework only.
"""

from __future__ import annotations

import ctypes
import enum
import os
import signal
import threading
import time
from typing import Optional

from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)


class Fault(enum.Enum):
    EXC = enum.auto()  # raise in the calling thread
    ASYNC_EXC = enum.auto()  # async-raise into the main thread from a helper thread
    SIGKILL = enum.auto()  # kill the process
    SIGTERM = enum.auto()
    SIGSTOP = enum.auto()  # stop (simulates a wedged-but-alive process)
    SEGFAULT = enum.auto()  # native crash
    LOCK_GIL = enum.auto()  # hold the GIL forever in a helper thread
    SLEEP = enum.auto()  # block the calling thread (soft timeout)
    GIL_SLEEP = enum.auto()  # hold the GIL in long chunks for `duration` seconds
    EXIT = enum.auto()  # os._exit without cleanup
    DEVICE_HANG = enum.auto()  # launch a kernel that never ends and wait for it
    DEVICE_ERROR = enum.auto()  # trap on the card: every later CUDA call raises


class InjectedFault(Exception):
    pass


def _segfault() -> None:
    ctypes.memmove(1, 2, 3)  # write to an unmapped address


def _lock_gil() -> None:
    # PyEval-level spin with the GIL held: pure-Python hot loop in a thread that
    # never yields via C calls barely exists in CPython; use ctypes to call a
    # blocking C function while holding the GIL instead.
    libc = ctypes.CDLL(None, use_errno=True)
    pythonapi = ctypes.pythonapi
    pythonapi.PyGILState_Ensure.restype = ctypes.c_void_p
    pythonapi.PyGILState_Ensure()
    libc.sleep(3600)  # blocks holding the GIL: no other thread can run Python


#: seconds per GIL-holding chunk of :data:`Fault.GIL_SLEEP`. Detection design
#: point: a chunk must exceed the heartbeat timeout under test (no beat can
#: land mid-chunk), while the ~instantaneous gap between chunks is the moment
#: the hang-forensics stack capture (``utils/stackdump.py``) can run — a
#: bounded, observable version of the unbounded LOCK_GIL wedge.
GIL_SLEEP_CHUNK_S = 2.0


def _gil_sleep(duration: float, chunk_s: Optional[float] = None) -> None:
    """Hold the GIL in ``chunk_s`` blocks until ``duration`` elapses.

    ``ctypes.PyDLL`` calls do NOT release the GIL (unlike ``CDLL``), so every
    other Python thread — heartbeats included — freezes for each chunk;
    between chunks the interpreter briefly schedules the starved threads,
    which is where a requested stack dump captures this frame. ``chunk_s``
    defaults to :data:`GIL_SLEEP_CHUNK_S` at call time so tests can retune
    the module constant against their detection timeouts."""
    if chunk_s is None:
        chunk_s = GIL_SLEEP_CHUNK_S
    libc = ctypes.PyDLL(None, use_errno=True)
    deadline = time.monotonic() + duration
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return
        hold_us = int(min(chunk_s, remaining) * 1e6)
        if hold_us > 0:
            libc.usleep(hold_us)  # GIL held for the whole call


FAULT_KERNELS = "faults"  # csrc/faults.cu


def _fault_lib():
    from tpu_resiliency_torch.ops import _build

    lib = _build.load(FAULT_KERNELS).lib
    if lib.tr_fault_spin.argtypes is None:
        lib.tr_fault_spin.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.tr_fault_spin.restype = ctypes.c_int
        lib.tr_fault_trap.argtypes = [ctypes.c_void_p]
        lib.tr_fault_trap.restype = ctypes.c_int
        lib.tr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_launch(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.tr_cuda_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what} kernel launch failed: {msg} (cudaError {code})")


def launch_spin(device):
    """Launch the spin kernel of ``csrc/faults.cu`` on ``device``'s current stream
    (one block of one thread) and return at once; the kernel never ends. Adds one to
    ``launch_spin.launches``. Returns the never-written word it spins on: the caller
    holds it for as long as the kernel runs, so its memory is never handed out and
    written."""
    import torch

    dev = torch.device(device)
    lib = _fault_lib()
    never_written = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check_launch(lib, lib.tr_fault_spin(never_written.data_ptr(), stream), "spin")
    launch_spin.launches += 1
    return never_written


def launch_trap(device) -> None:
    """Launch the trap kernel of ``csrc/faults.cu`` on ``device``'s current stream
    (one block of one thread). The launch succeeds; the sticky error shows at the
    next wait on the card. Adds one to ``launch_trap.launches``."""
    import torch

    dev = torch.device(device)
    lib = _fault_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check_launch(lib, lib.tr_fault_trap(stream), "trap")
    launch_trap.launches += 1


#: Launches of each fault kernel (CUDA only).
launch_spin.launches = 0
launch_trap.launches = 0


def _device_hang(device) -> None:
    """Block the calling thread in a device wait that never completes: the spin
    kernel, then ``torch.cuda.synchronize``, which parks the thread in the CUDA
    driver with the GIL released, where async exceptions cannot reach it (the
    reference parks in ``block_until_ready``). Only the monitor process's
    hard-timeout ladder gets a rank out of this state. On the CPU: a C-level sleep
    with the GIL released, forever."""
    import torch

    from tpu_resiliency_torch.platform.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        libc = ctypes.CDLL(None, use_errno=True)  # CDLL calls release the GIL
        while True:
            libc.sleep(3600)
    never_written = launch_spin(dev)  # held: the kernel reads it until the end
    torch.cuda.synchronize(dev)  # never returns
    raise RuntimeError(f"the spin kernel returned ({never_written.item()})")


def _device_error(device) -> None:
    """Kill the device runtime. On the card: the trap kernel, then a wait that
    surfaces its sticky error (swallowed here; it is the point) — from then on every
    CUDA call of the process raises, the liveness probe answers ``False`` and
    ``CudaHealthCheck`` raises. Raises if the wait saw no error. On the CPU: the
    dead-runtime mark, which :func:`heal_device_error` clears."""
    import torch

    from tpu_resiliency_torch.platform import device as port_device

    dev = port_device.resolve_device(device)
    if dev.type == "cpu":
        port_device.set_cpu_runtime_dead(True)
        return
    launch_trap(dev)
    try:
        torch.cuda.synchronize(dev)
    except Exception as e:  # torch.AcceleratorError on newer torch, RuntimeError before
        log.warning(f"device error injected: {e}")
        return
    raise RuntimeError("the trap kernel ran without a device error")


def heal_device_error(device=None) -> None:
    """Undo :data:`Fault.DEVICE_ERROR` on the CPU (for tests). On the card a sticky
    CUDA error cannot be undone in the process that took it: this raises, and only
    a new process gets a working context."""
    from tpu_resiliency_torch.platform import device as port_device

    dev = port_device.resolve_device(device)
    if dev.type != "cpu":
        raise RuntimeError(
            "a sticky CUDA error cannot be undone: the process's context is lost; "
            "restart the process (the in-job launcher's layer)"
        )
    port_device.set_cpu_runtime_dead(False)


def inject_fault(
    fault: Fault,
    delay: float = 0.0,
    duration: float = 30.0,
    in_thread: bool = False,
    device=None,
) -> Optional[threading.Thread]:
    """Trigger ``fault`` after ``delay`` seconds (in a helper thread if requested or
    inherently asynchronous). ``device`` is where the device faults strike:
    ``None`` means the card (raises without one), ``"cpu"`` the CPU's stand-ins."""

    def fire() -> None:
        if delay > 0:
            time.sleep(delay)
        log.warning(f"injecting fault {fault.name} (pid {os.getpid()})")
        if fault == Fault.EXC:
            raise InjectedFault(f"injected {fault.name}")
        if fault == Fault.ASYNC_EXC:
            main_id = threading.main_thread().ident
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(main_id), ctypes.py_object(InjectedFault)
            )
            return
        if fault in (Fault.SIGKILL, Fault.SIGTERM, Fault.SIGSTOP):
            sig = {
                Fault.SIGKILL: signal.SIGKILL,
                Fault.SIGTERM: signal.SIGTERM,
                Fault.SIGSTOP: signal.SIGSTOP,
            }[fault]
            os.kill(os.getpid(), sig)
            return
        if fault == Fault.SEGFAULT:
            _segfault()
            return
        if fault == Fault.LOCK_GIL:
            _lock_gil()
            return
        if fault == Fault.SLEEP:
            time.sleep(duration)
            return
        if fault == Fault.GIL_SLEEP:
            _gil_sleep(duration)
            return
        if fault == Fault.EXIT:
            os._exit(3)
        if fault == Fault.DEVICE_HANG:
            _device_hang(device)
            return
        if fault == Fault.DEVICE_ERROR:
            _device_error(device)
            return
        raise ValueError(f"unknown fault {fault}")

    needs_thread = in_thread or fault in (Fault.ASYNC_EXC, Fault.LOCK_GIL)
    if delay > 0 or needs_thread:
        t = threading.Thread(target=fire, name=f"fault-{fault.name}", daemon=True)
        t.start()
        return t
    fire()
    return None
