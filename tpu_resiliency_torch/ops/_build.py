"""Build and load the port's CUDA kernels.

Each kernel source ``tpu_resiliency_torch/csrc/<name>.cu`` exposes a plain C
interface. It is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``build/tpu_resiliency_torch/`` beside the package, at first use, and loaded
with ``ctypes``. The library's file name carries a digest of the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source is never served by a
stale build. A failed build raises.

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
#: ``-D`` macros each kernel's source is compiled with, by kernel name. A limit that
#: the source and the Python side both need is set here once: the source does not
#: compile without it, and ``scoring_kernels`` reads it from here.
DEFINES: dict[str, dict[str, int]] = {
    "median_weights": {"TR_NETWORK_MAX_WINDOW": 64},
    "median_weights_pairwise": {"TR_PAIRWISE_REGISTER_MAX_WINDOW": 64},
}

_lock = threading.Lock()
_loaded: dict[str, "BuiltLibrary"] = {}
#: ``nvcc`` runs this process started (a restarted worker over a built tree runs none)
nvcc_runs = 0


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


def _flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{k}={v}" for k, v in sorted(DEFINES.get(name, {}).items()))


def _paths(name: str) -> tuple[Path, Path, Path]:
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"kernel source {src} is missing")
    h = hashlib.sha256(src.read_bytes() + " ".join(_flags(name)).encode())
    for header in sorted(CSRC_DIR.glob("*.cuh")):  # sources include them
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    return src, out, out.with_suffix(".json")


def _ptxas_lines(stderr: str) -> tuple[str, ...]:
    """ptxas's register, shared-memory and spill lines, each kernel's after the line
    that names it (``Compiling entry function``)."""
    keys = ("entry function", "registers", "spill", "smem")
    return tuple(
        line.strip() for line in stderr.splitlines() if any(k in line for k in keys)
    )


def ptxas_by_kernel(lines) -> dict[str, dict[str, int]]:
    """Per kernel (mangled name) of a build's ptxas lines: ``registers``,
    ``stack_frame``, ``spill_stores`` and ``spill_loads`` in bytes or counts."""
    out: dict[str, dict[str, int]] = {}
    current = None
    for line in lines:
        if "entry function" in line:
            current = out.setdefault(line.split("'")[1], {})
            continue
        if current is None:
            continue
        words = line.replace(",", " ").split()
        for i, w in enumerate(words[2:], 2):
            if w == "registers" and words[i - 1].isdigit():
                current["registers"] = int(words[i - 1])
            elif w == "stack" and words[i - 2].isdigit():
                current["stack_frame"] = int(words[i - 2])
            elif w == "spill" and words[i - 2].isdigit() and i + 1 < len(words):
                current[f"spill_{words[i + 1]}"] = int(words[i - 2])
    return out


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
    global nvcc_runs
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, src, out, meta in pending:
        nvcc_runs += 1
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(name), "-o", str(tmp), str(src)]
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


def is_built(name: str) -> bool:
    """Whether kernel ``name``'s library for the current sources is on disk."""
    _, out, meta = _paths(name)
    return out.is_file() and meta.is_file()


def load(name: str) -> BuiltLibrary:
    """The loaded library for kernel ``name``, built first if needed. Loading opens
    the library and touches no device: CUDA starts at the first launch."""
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
