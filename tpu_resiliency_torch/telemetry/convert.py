"""Carrying telemetry state across packages.

This system has no weights: the state a run carries is the telemetry state. These
functions turn the JAX package's ``TelemetryState`` leaves, as numpy arrays, into
the port's :class:`TelemetryState` and back, so that a run can move between the two
packages mid-way (a wrapped ring, a carried EWMA, a finite historical minimum).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_resiliency_torch.platform.device import resolve_device
from tpu_resiliency_torch.telemetry.sharded import TelemetryState


def telemetry_state_from_numpy(data, counts, cursor, ewma, hist_min, device=None) -> TelemetryState:
    """The port's state from numpy leaves: ``data`` f32 [W, R, S], ``counts`` i32
    [R, S], ``cursor`` integer scalar, ``ewma`` f32 [R], ``hist_min`` f32 [R, S].
    ``device=None`` means the CUDA card."""
    dev = resolve_device(device)
    data = np.asarray(data, dtype=np.float32)
    w, r, s = data.shape
    counts = np.asarray(counts, dtype=np.int32)
    ewma = np.asarray(ewma, dtype=np.float32)
    hist_min = np.asarray(hist_min, dtype=np.float32)
    if counts.shape != (r, s) or ewma.shape != (r,) or hist_min.shape != (r, s):
        raise ValueError(
            f"leaf shapes disagree with data [W={w}, R={r}, S={s}]: counts "
            f"{counts.shape}, ewma {ewma.shape}, hist_min {hist_min.shape}"
        )

    def put(x, dtype):
        return torch.tensor(x, dtype=dtype, device=dev)

    return TelemetryState(
        data=put(data, torch.float32),
        counts=put(counts, torch.int32),
        cursor=put(int(np.asarray(cursor)), torch.int64),
        ewma=put(ewma, torch.float32),
        hist_min=put(hist_min, torch.float32),
    )


def telemetry_state_to_numpy(state: TelemetryState):
    """Inverse of :func:`telemetry_state_from_numpy`: ``(data, counts, cursor, ewma,
    hist_min)`` as numpy arrays (``cursor`` an int32 scalar, as the JAX state holds it)."""
    return (
        state.data.cpu().numpy(),
        state.counts.cpu().numpy(),
        np.asarray(int(state.cursor), dtype=np.int32),
        state.ewma.cpu().numpy(),
        state.hist_min.cpu().numpy(),
    )
