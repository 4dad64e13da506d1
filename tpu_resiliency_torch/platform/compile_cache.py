"""Persistent compilation caches that survive in-job restarts.

A copy of ``tpu_resiliency/platform/compile_cache.py`` (its CRC manifest, ``scan``,
``sweep``, ``write_manifest`` and the once-per-process ``compile_cache`` event) that
points PyTorch's compilers at the cache directory instead of JAX's: :func:`enable`
exports :data:`INDUCTOR_CACHE_ENV` and :data:`TRITON_CACHE_ENV` under it, so a
restarted worker's ``torch.compile``d step loads the previous round's Inductor
artifacts and Triton binaries instead of compiling them again.

- ``python -m tpu_resiliency_torch.launcher.launch --compile-cache-dir DIR`` exports
  :data:`CACHE_DIR_ENV` and both compiler variables to every worker.
- Workers apply it through :func:`apply_from_env` (called by ``inprocess/wrap.py`` at
  engine start and by ``platform/device.py:apply_platform_env``), which records one
  ``compile_cache`` event per process: outcome ``hit``, ``miss`` or ``miss_corrupt``.

The port's own CUDA kernels are not in this cache: they build into the checkout's
``build/`` directory, keyed by a digest of their sources (``ops/_build.py``).

The integrity sweep judges every file under ``DIR/inductor`` and ``DIR/triton``
(walked recursively, keyed in the manifest by the path relative to ``DIR``; Inductor's
``.lock`` files are no entries), and the top-level ``*-cache`` entries of JAX's layout
as the reference does, so a warm torch.compile cache counts as a ``hit`` and a torn
Inductor or Triton file is purged to a cold compile.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Optional

from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)

#: exported by the launcher; consumed by :func:`apply_from_env` in workers
CACHE_DIR_ENV = "TPU_RESILIENCY_COMPILE_CACHE_DIR"

#: torch.compile's caches, each in a directory of its own under the cache dir
INDUCTOR_CACHE_ENV = "TORCHINDUCTOR_CACHE_DIR"
TRITON_CACHE_ENV = "TRITON_CACHE_DIR"


def compiler_cache_env(path: str) -> dict[str, str]:
    """The compiler cache variables for cache directory ``path``."""
    return {INDUCTOR_CACHE_ENV: os.path.join(path, "inductor"),
            TRITON_CACHE_ENV: os.path.join(path, "triton")}


#: integrity manifest file kept inside the cache dir (never a cache entry:
#: JAX entry files end in ``-cache``)
MANIFEST_NAME = "MANIFEST.tpures.json"

#: only files with this suffix are cache entries (JAX writes ``<key>-cache``
#: payloads plus tiny ``-atime`` stamps we ignore)
_ENTRY_SUFFIX = "-cache"

#: torch.compile's cache directories under the cache dir (``compiler_cache_env``):
#: every file in them, at any depth, is an entry
_COMPILER_DIRS = ("inductor", "triton")

#: files in the compiler directories that are no entries (Inductor's file locks)
_NOT_ENTRY_SUFFIXES = (".lock",)

#: process-level latch: the cache is applied (and its event recorded) once
_applied: Optional[dict] = None


def _entry_names(path: str) -> list[str]:
    """The entries under ``path``, each named by its path relative to ``path``:
    top-level ``*-cache`` files, then every file below the compiler directories."""
    try:
        names = [n for n in os.listdir(path) if n.endswith(_ENTRY_SUFFIX)]
    except OSError:
        return []
    for sub in _COMPILER_DIRS:
        for dirpath, _, files in os.walk(os.path.join(path, sub)):
            rel = os.path.relpath(dirpath, path).replace(os.sep, "/")
            names.extend(f"{rel}/{f}" for f in files if not f.endswith(_NOT_ENTRY_SUFFIXES))
    return sorted(names)


def _digest_file(p: str) -> tuple[int, int]:
    """(size, crc32) of a file, streamed."""
    crc = 0
    size = 0
    with open(p, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
    return size, crc


def scan(path: str) -> dict[str, list[int]]:
    """{entry_name: [size, crc32]} for every cache entry currently on disk."""
    out: dict[str, list[int]] = {}
    for name in _entry_names(path):
        try:
            size, crc = _digest_file(os.path.join(path, name))
        except OSError:
            continue  # racing writer/deleter: skip, never raise
        out[name] = [size, crc]
    return out


def write_manifest(path: str) -> int:
    """Atomically record the current entry digests; returns the entry count.
    Best-effort: an unwritable cache dir is a log line, not a failure."""
    entries = scan(path)
    doc = {"version": 1, "entries": entries}
    tmp = os.path.join(path, f"{MANIFEST_NAME}.tmp.{os.getpid()}")
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, os.path.join(path, MANIFEST_NAME))
    except OSError:
        log.debug("compile-cache manifest write failed", exc_info=True)
        try:
            os.unlink(tmp)
        except OSError:
            pass
    return len(entries)


def read_manifest(path: str) -> dict[str, list[int]]:
    try:
        with open(os.path.join(path, MANIFEST_NAME)) as f:
            doc = json.load(f)
        entries = doc.get("entries")
        return entries if isinstance(entries, dict) else {}
    except (OSError, ValueError):
        return {}


def sweep(path: str) -> dict:
    """Verify manifest-covered entries; purge mismatches (truncated, bit-flipped,
    torn) so they cost a cold compile instead of a decode failure — or worse.

    Returns ``{"entries", "bytes", "purged", "unverified"}`` where ``entries``/
    ``bytes`` count the cache AFTER the purge and ``unverified`` counts entries
    newer than the manifest (left in place for JAX's own fallback).
    """
    manifest = read_manifest(path)
    purged = 0
    for name, want in sorted(manifest.items()):
        p = os.path.join(path, name)
        if not os.path.exists(p):
            continue  # evicted/cleaned: not corruption
        try:
            size, crc = _digest_file(p)
        except OSError:
            continue
        if [size, crc] != list(want):
            log.warning(
                f"compile cache entry {name} fails integrity "
                f"({size}B/crc{crc:08x} != manifest {want}); purging — "
                "this program will cold-compile"
            )
            stamp = [p[: -len(_ENTRY_SUFFIX)] + "-atime"] if "/" not in name else []
            for victim in (p, *stamp):
                try:
                    os.unlink(victim)
                except OSError:
                    pass
            purged += 1
    entries = 0
    total = 0
    names = _entry_names(path)
    for name in names:
        try:
            total += os.path.getsize(os.path.join(path, name))
            entries += 1
        except OSError:
            continue
    unverified = sum(1 for n in names if n not in manifest)
    return {
        "entries": entries, "bytes": total,
        "purged": purged, "unverified": unverified,
    }


def outcome_of(stats: dict) -> str:
    """Classify a sweep for the ``compile_cache`` event / metric."""
    if stats.get("purged"):
        return "miss_corrupt"
    return "hit" if stats.get("entries") else "miss"


def enable(path: str) -> dict:
    """Sweep ``path``, point torch.compile's Inductor and Triton caches under it
    (:func:`compiler_cache_env`), and register an exit-time manifest refresh.
    Returns the sweep stats.

    Every failure mode degrades to a cold compile: an unusable directory simply
    leaves caching off. The variables are read when a compiler first looks for
    its cache, so apply this before the first ``torch.compile``d call."""
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        log.warning(f"compile cache dir {path!r} unusable; caching disabled")
        return {"entries": 0, "bytes": 0, "purged": 0, "unverified": 0,
                "enabled": False}
    stats = sweep(path)
    stats["enabled"] = True
    os.environ.update(compiler_cache_env(path))
    import atexit

    atexit.register(lambda: write_manifest(path))
    return stats


def apply_from_env(record: bool = True) -> Optional[dict]:
    """Apply :data:`CACHE_DIR_ENV` once per process; None when unset or when
    already applied. On first application records the ``compile_cache``
    event (hit / miss / miss_corrupt + entry count and bytes)."""
    global _applied
    path = os.environ.get(CACHE_DIR_ENV, "")
    if not path or _applied is not None:
        return None
    stats = enable(path)
    stats["outcome"] = outcome_of(stats)
    _applied = stats
    if record and stats.get("enabled"):
        from tpu_resiliency_torch.utils.events import record as record_event

        record_event(
            "platform", "compile_cache",
            outcome=stats["outcome"], entries=stats["entries"],
            bytes=stats["bytes"], purged=stats["purged"],
            unverified=stats["unverified"], dir=path,
        )
    return stats


def refresh_manifest_from_env() -> None:
    """Launcher-side post-round manifest refresh: covers workers that died
    without their atexit hook (SIGKILL, OOM). Cheap — CRC of a few files."""
    path = os.environ.get(CACHE_DIR_ENV, "")
    if path and os.path.isdir(path):
        write_manifest(path)
