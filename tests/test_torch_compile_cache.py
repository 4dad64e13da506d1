"""The port's persistent compilation cache, held against
``tests/platform/test_compile_cache.py``: its manifest, sweep and outcome tests run here
on ``tpu_resiliency_torch.platform.compile_cache`` (``torch_port_tests``), its metrics
bridge on the port's ``utils/metrics.py``. Its two JIT tests
compile a JAX program in a worker; the port's cache is torch.compile's, answered
below: a worker applying the launcher's variable gets Inductor's and Triton's cache
directories under the cache dir and records one ``compile_cache`` event, whose outcome
follows the sweep (``hit`` over an intact entry, ``miss_corrupt`` over a damaged one),
and the Wrapper applies it at engine start as the reference's does. The sweep walks
``inductor/`` and ``triton/``: on the layout a CPU ``torch.compile`` writes (gcc), a cold
compile is a ``miss``, a warm one a ``hit``, and a torn ``fxgraph`` entry is purged
(``miss_corrupt``), as the reference's JIT tests assert them for JAX's cache.
"""

import json
import os
import subprocess
import sys

import pytest

from tests.torch_port_tests import REPO, port_tests
from tpu_resiliency_torch.platform import compile_cache

port_tests(
    "tests/platform/test_compile_cache.py", globals(),
    leave_out={
        "test_cold_then_warm_start_hits": "compiles with JAX; answered below for torch.compile",
        "test_truncated_entry_is_purged_to_cold_compile": "compiles with JAX; answered below",
    },
)

APPLY_SNIPPET = """
import json, os, sys
from tpu_resiliency_torch.platform import device
device.apply_platform_env()
device.apply_platform_env()  # once per process: no second event
keys = ("TORCHINDUCTOR_CACHE_DIR", "TRITON_CACHE_DIR")
with open(sys.argv[1], "w") as fh:
    json.dump({k: os.environ.get(k) for k in keys}, fh)
"""

WRAPPER_SNIPPET = """
import os, sys
os.environ.update(RANK="0", WORLD_SIZE="1", TPU_RESILIENCY_STORE_HOST="127.0.0.1",
                  TPU_RESILIENCY_STORE_PORT=sys.argv[1])
from tpu_resiliency_torch.inprocess import Wrapper

@Wrapper(monitor_interval=0.05, last_call_wait=0.05, heartbeat_interval=0.2)
def train():
    return os.environ.get("TORCHINDUCTOR_CACHE_DIR")

print("CACHE " + str(train()))
"""


def _run(tmp_path, snippet, cache, tag, *argv):
    events = tmp_path / f"events_{tag}.jsonl"
    env = dict(os.environ, PYTHONPATH=str(REPO), TPU_RESILIENCY_EVENTS_FILE=str(events))
    env[compile_cache.CACHE_DIR_ENV] = str(cache)
    for k in ("TORCHINDUCTOR_CACHE_DIR", "TRITON_CACHE_DIR"):
        env.pop(k, None)
    r = subprocess.run([sys.executable, "-c", snippet, *map(str, argv)], capture_output=True,
                       text=True, timeout=120, env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    evs = [json.loads(ln) for ln in events.read_text().splitlines()] if events.exists() else []
    return r.stdout, [e for e in evs if e.get("kind") == "compile_cache"]


def test_a_worker_points_torch_compile_under_the_cache_dir(tmp_path):
    cache = tmp_path / "cc"
    out = tmp_path / "env.json"
    _, cc = _run(tmp_path, APPLY_SNIPPET, cache, "cold", out)
    assert json.loads(out.read_text()) == {"TORCHINDUCTOR_CACHE_DIR": str(cache / "inductor"),
                                           "TRITON_CACHE_DIR": str(cache / "triton")}
    assert len(cc) == 1 and cc[0]["outcome"] == "miss" and cc[0]["dir"] == str(cache), cc


@pytest.mark.parametrize("damage,outcome", [(False, "hit"), (True, "miss_corrupt")])
def test_the_event_follows_the_sweep(tmp_path, damage, outcome):
    cache = tmp_path / "cc"
    cache.mkdir()
    (cache / "prog-cache").write_bytes(b"compiled program" * 64)
    compile_cache.write_manifest(str(cache))
    if damage:
        with open(cache / "prog-cache", "r+b") as f:
            f.truncate(100)
    _, cc = _run(tmp_path, APPLY_SNIPPET, cache, "warm", tmp_path / "env.json")
    assert len(cc) == 1 and cc[0]["outcome"] == outcome, cc
    assert cc[0]["purged"] == int(damage)
    assert (cache / "prog-cache").exists() is (not damage)


def test_the_wrapper_applies_the_cache_at_engine_start(tmp_path):
    import socket

    with socket.socket() as s:  # rank 0 hosts its store on a free port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cache = tmp_path / "cc"
    out, cc = _run(tmp_path, WRAPPER_SNIPPET, cache, "wrap", port)
    assert f"CACHE {cache / 'inductor'}" in out
    assert len(cc) == 1 and cc[0]["outcome"] == "miss", cc


COMPILE_SNIPPET = """
import sys
from tpu_resiliency_torch.platform import device
device.apply_platform_env()
import torch
f = torch.compile(lambda x: (x.sin() * 2 + 1).sum())
x = torch.linspace(-1.0, 1.0, 16)
print("VALUE " + repr(float(f(x))) + " " + repr(float((x.sin() * 2 + 1).sum())))
"""


def _compile(tmp_path, cache, tag):
    out, cc = _run(tmp_path, COMPILE_SNIPPET, cache, tag)
    got, want = map(float, out.split("VALUE ", 1)[1].split())
    assert abs(got - want) <= 1e-5 * abs(want), out
    assert len(cc) == 1, cc
    return cc[0]


@pytest.fixture(scope="module")
def compiled_cache(tmp_path_factory):
    """A cache dir that one CPU ``torch.compile`` filled (Inductor's own layout:
    hashed subdirectories, ``fxgraph/``, ``aotautograd/``, ``locks/``), and its cold
    event."""
    tmp = tmp_path_factory.mktemp("torch_compile")
    cache = tmp / "cc"
    return cache, _compile(tmp, cache, "cold")


def _entry_files(cache):
    return sorted(str(p.relative_to(cache)) for p in (cache / "inductor").rglob("*")
                  if p.is_file() and p.suffix != ".lock")


def test_a_cold_torch_compile_is_a_miss_that_leaves_entries_under_inductor(compiled_cache):
    cache, cold = compiled_cache
    assert cold["outcome"] == "miss" and cold["entries"] == 0, cold
    entries = _entry_files(cache)
    assert any(e.startswith("inductor/fxgraph/") for e in entries), entries
    manifest = compile_cache.read_manifest(str(cache))
    assert sorted(manifest) == entries  # the exit-time manifest, keyed by relative path
    assert not any(k.endswith(".lock") for k in manifest)


@pytest.mark.parametrize("damage,outcome", [(False, "hit"), (True, "miss_corrupt")])
def test_a_warm_torch_compile_cache_is_swept_as_the_reference_sweeps(
        compiled_cache, tmp_path, damage, outcome):
    import shutil

    src, _ = compiled_cache
    cache = tmp_path / "cc"
    shutil.copytree(src, cache)
    entries = _entry_files(cache)
    victim = cache / next(e for e in entries if e.startswith("inductor/fxgraph/"))
    if damage:
        with open(victim, "r+b") as f:
            f.truncate(max(1, victim.stat().st_size // 2))
    ev = _compile(tmp_path, cache, "warm")
    assert ev["outcome"] == outcome, ev
    assert ev["purged"] == int(damage)
    assert ev["entries"] == len(entries) - int(damage) and ev["bytes"] > 0, ev
    assert ev["unverified"] == 0, ev
    assert victim.exists() is (not damage)
