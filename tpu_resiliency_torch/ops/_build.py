"""Build and load the port's CUDA kernels.

Each kernel source ``tpu_resiliency_torch/csrc/<name>.cu`` exposes a plain C
interface. It is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``build/tpu_resiliency_torch/`` beside the package, at first use, and loaded
with ``ctypes``. The library's file name carries a digest of the source and the
flags, so an edited source is never served by a stale build. A failed build raises.

Nothing here runs at import: the CPU tests import every module of the port, and this
machine-independent module must import where there is no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Iterable

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "tpu_resiliency_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, "BuiltLibrary"] = {}


@dataclasses.dataclass(frozen=True)
class BuiltLibrary:
    """One compiled kernel library and what its build reported."""

    lib: ctypes.CDLL
    build_seconds: float  # wall time of the nvcc run that produced the library
    ptxas: tuple[str, ...]  # ptxas register / shared-memory / spill lines


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the port's CUDA "
        "kernels are compiled at first use and need the CUDA toolkit"
    )


def _paths(name: str) -> tuple[Path, Path, Path]:
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"kernel source {src} is missing")
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    return src, out, out.with_suffix(".json")


def _ptxas_lines(stderr: str) -> tuple[str, ...]:
    return tuple(
        line.strip()
        for line in stderr.splitlines()
        if "registers" in line or "spill" in line or "smem" in line
    )


def build(names: Iterable[str]) -> None:
    """Compile every named kernel whose library is not built yet, all ``nvcc`` runs
    started together, and record each build's seconds and ptxas lines beside it."""
    pending = []
    for name in names:
        src, out, meta = _paths(name)
        if out.is_file() and meta.is_file():
            continue
        pending.append((name, src, out, meta))
    if not pending:
        return
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, src, out, meta in pending:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((name, out, meta, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )))
    failures = []
    for name, out, meta, tmp, t0, proc in procs:
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{stdout}{stderr}")
            continue
        os.replace(tmp, out)
        meta.write_text(json.dumps(
            {"build_seconds": seconds, "ptxas": list(_ptxas_lines(stderr))}
        ))
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))


def load(name: str) -> BuiltLibrary:
    """The loaded library for kernel ``name``, built first if needed."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        build([name])
        _, out, meta = _paths(name)
        info = json.loads(meta.read_text())
        built = BuiltLibrary(
            lib=ctypes.CDLL(str(out)),
            build_seconds=float(info["build_seconds"]),
            ptxas=tuple(info["ptxas"]),
        )
        _loaded[name] = built
        return built
