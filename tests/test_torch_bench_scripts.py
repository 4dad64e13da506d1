"""The repo-root scripts that run on the port's modules, held against the reference's
``scripts/``: ``bench_reshard.py`` (a port onto the port's checkpoint layer) and the
copies ``bench_store.py``, ``bench_replication.py``, ``bench_fleet.py`` and
``bench_ckpt_io.py`` (``tests/test_torch_support_copies.py`` lists each edit).

- ``bench_reshard`` runs in this process at its smallest size (``--smoke``'s 2 MB) in
  both packages: the bytes each path moved must be equal, and so must every shard the
  survivors restored, bit for bit, since the two packages' containers interchange byte
  for byte.
- One small run of each copy exits 0 and prints or writes the reference's keys.
- The reference's perf acceptance tests of these scripts (``slow``) run on the port
  through ``torch_port_tests``. The edits: each starts the port's module (the fleet
  bench with ``--device cpu``, since the port's jobs run on the card by default), and
  the repo root is the port test's parent (the reference's tests lie a directory
  deeper). The tests that gate the reference's committed ``BENCH_*.json`` are left
  out: the port commits no result file, its runs write under ``build/``.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.torch_port_tests import REPO, port_tests
from tpu_resiliency.checkpoint.local_manager import LocalCheckpointManager as RefManager
from tpu_resiliency_torch.checkpoint.local_manager import LocalCheckpointManager
from tpu_resiliency_torch.scripts import bench_reshard

ROOT_FROM_HERE = ("the reference's tests lie a directory deeper; the repo root is the "
                  "port test's parent")
COMMITTED = "gates the reference's committed result file; the port commits none"


def _module(old_path: str, module: str, extra: str = "") -> tuple:
    return (f'os.path.join(REPO_ROOT, "scripts", "{old_path}"),',
            f'"-m", "tpu_resiliency_torch.scripts.{module}",{extra}',
            "the port's module")


_REPO_ROOT_3 = ('REPO_ROOT = os.path.dirname(\n'
                '    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))\n)',
                "REPO_ROOT = str(REPO)", ROOT_FROM_HERE)
_REPO_ROOT_1 = ("REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname("
                "os.path.abspath(__file__))))", "REPO_ROOT = str(REPO)", ROOT_FROM_HERE)
_REPO_1 = ("REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))",
           "REPO = str(globals()['REPO'])", ROOT_FROM_HERE)

port_tests(
    "tests/checkpoint/test_reshard_perf.py", globals(),
    edits=[_REPO_ROOT_3,
           ('os.path.join(REPO_ROOT, "scripts", "bench_reshard.py"),\n            "--mb", "64", '
            '"--out"', '"-m", "tpu_resiliency_torch.scripts.bench_reshard",\n            "--mb", '
            '"64", "--out"', "the port's module"),
           ('os.path.join(REPO_ROOT, "scripts", "bench_reshard.py"),\n            "--mb", "64", '
            '"--with-1g"', '"-m", "tpu_resiliency_torch.scripts.bench_reshard",\n            '
            '"--mb", "64", "--with-1g"', "the port's module")],
    leave_out={"test_committed_bench_has_subsecond_resume_and_1g_scaling": COMMITTED,
               "test_committed_bench_replication_composed_leg": COMMITTED},
)
port_tests(
    "tests/checkpoint/test_replication_perf.py", globals(),
    edits=[_REPO_ROOT_1, _module("bench_replication.py", "bench_replication")],
)
port_tests(
    "tests/checkpoint/test_coding_perf.py", globals(),
    edits=[_REPO_ROOT_3, _module("bench_replication.py", "bench_replication")],
)
port_tests(
    "tests/platform/test_store_perf.py", globals(),
    edits=[_REPO_1,
           ("import bench_store  # noqa: E402",
            "from tpu_resiliency_torch.scripts import bench_store  # noqa: E402",
            "the port's module")],
    leave_out={"test_committed_bench_has_ha_legs": COMMITTED},
)
port_tests(
    "tests/fleet/test_fleet_perf.py", globals(),
    edits=[_REPO_1,
           ('os.path.join(REPO, "scripts", "bench_fleet.py"),',
            '"-m", "tpu_resiliency_torch.scripts.bench_fleet", "--device", "cpu",',
            "the port's module; its jobs run on the card by default")],
)


def _reference_script(name: str):
    spec = importlib.util.spec_from_file_location(f"ref_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _resharded(module, manager_cls, monkeypatch) -> tuple[dict, dict]:
    """``module.bench(2)``, and each survivor's restored leaves from its
    ``load_resharded``."""
    shards = {}
    load = manager_cls.load_resharded

    def spy(self, *a, **kw):
        hollow, tensors, meta = load(self, *a, **kw)
        shards[self.rank] = [np.asarray(t).copy() for t in tensors]
        return hollow, tensors, meta

    with monkeypatch.context() as m:
        m.setattr(manager_cls, "load_resharded", spy)
        return module.bench(2), shards


def test_bench_reshard_moves_and_restores_what_the_reference_does(monkeypatch):
    ref, ref_shards = _resharded(_reference_script("bench_reshard"), RefManager, monkeypatch)
    got, shards = _resharded(bench_reshard, LocalCheckpointManager, monkeypatch)
    assert sorted(got) == sorted(ref)
    for key in ("world", "shrink_to", "mb", "ranged_peer_bytes", "ranged_local_bytes",
                "full_peer_bytes", "bytes_ratio"):
        assert got[key] == ref[key], key
    assert 0 < got["ranged_peer_bytes"] < got["full_peer_bytes"]
    assert sorted(shards) == sorted(ref_shards) == [0, 1, 2]
    for rank, leaves in ref_shards.items():
        assert len(shards[rank]) == len(leaves)
        for a, b in zip(shards[rank], leaves):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes(), rank


def _run(argv, timeout=300.0) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, *argv], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=REPO)


def _json_lines(text: str) -> list[dict]:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def test_bench_store_smoke_prints_the_references_lines():
    ref = _run(["scripts/bench_store.py", "--smoke"])
    got = _run(["-m", "tpu_resiliency_torch.scripts.bench_store", "--smoke"])
    assert ref.returncode == 0 and got.returncode == 0, got.stdout[-2000:] + got.stderr[-3000:]
    assert [sorted(d) for d in _json_lines(got.stdout)] == [
        sorted(d) for d in _json_lines(ref.stdout)]
    assert _json_lines(got.stdout)[-1]["bench_store_smoke"] == "PASS"


def test_bench_replication_smoke_writes_the_references_keys(tmp_path):
    ref = _run(["scripts/bench_replication.py", "--smoke", "--out", str(tmp_path / "r.json")])
    got = _run(["-m", "tpu_resiliency_torch.scripts.bench_replication", "--smoke", "--out",
                str(tmp_path / "p.json")])
    assert ref.returncode == 0 and got.returncode == 0, got.stdout[-2000:] + got.stderr[-3000:]
    want = json.loads((tmp_path / "r.json").read_text())
    res = json.loads((tmp_path / "p.json").read_text())
    assert sorted(res) == sorted(want)
    for key, value in want.items():
        if isinstance(value, dict):
            assert sorted(res[key]) == sorted(value), key
    assert "bench_replication smoke: PASS" in got.stdout


def test_bench_ckpt_io_prints_the_references_lines():
    argv = ["--gib", "0.004", "--rounds", "1"]
    ref = _run(["scripts/bench_ckpt_io.py", *argv])
    got = _run(["-m", "tpu_resiliency_torch.scripts.bench_ckpt_io", *argv])
    assert ref.returncode == 0 and got.returncode == 0, got.stderr[-3000:]

    def labels(text):
        return [ln.split(":")[0] for ln in text.splitlines() if ln.strip()]

    assert labels(got.stdout) == labels(ref.stdout) == [
        "raw fan-out 1-way", "raw fan-out 4-way", "write_payload 1-way", "write_payload 4-way"]


def test_bench_reshard_smoke_passes_and_writes_under_build(tmp_path):
    got = _run(["-m", "tpu_resiliency_torch.scripts.bench_reshard", "--smoke", "--out",
                str(tmp_path / "sub" / "r.json")])
    assert got.returncode == 0, got.stdout[-2000:] + got.stderr[-3000:]
    assert "bench_reshard smoke: PASS" in got.stdout
    assert sorted(json.loads((tmp_path / "sub" / "r.json").read_text())) == sorted(
        json.loads((REPO / "BENCH_reshard.json").read_text()).keys() - {"leg_1g"})
    from tpu_resiliency_torch.scripts import DEFAULT_OUT_DIR

    assert DEFAULT_OUT_DIR.startswith(str(REPO / "build"))


def test_bench_fleet_smoke_writes_the_references_keys(tmp_path):
    """Two and four 2-rank jobs of ``examples/resilient_training.py`` on the CPU under
    the port's launcher, each crashing once in round 0, scraped by the port's fleet
    aggregator; the report carries the committed reference run's keys."""
    out = tmp_path / "fleet.json"
    got = _run(["-m", "tpu_resiliency_torch.scripts.bench_fleet", "--smoke", "--device", "cpu",
                "--out", str(out)], timeout=580)
    assert got.returncode == 0, got.stdout[-3000:] + got.stderr[-3000:]
    res = json.loads(out.read_text())
    want = json.loads((REPO / "BENCH_fleet.json").read_text())
    assert sorted(res) == sorted(want)
    assert sorted(res["config"]) == sorted([*want["config"], "device"])
    assert res["config"]["device"] == "cpu"
    assert [r["jobs"] for r in res["scrape_cost"]] == res["config"]["sizes"] == [2, 4]
    assert res["kill"]["all_200"] and res["kill"]["victim_status"] == "unreachable"


@pytest.mark.parametrize("script", ["bench_store", "bench_replication", "bench_fleet",
                                    "bench_ckpt_io", "bench_reshard", "chaos_soak"])
def test_the_script_imports_nothing_of_the_reference(script):
    """Also covers the child scripts and command lines a script writes or runs."""
    text = (REPO / "tpu_resiliency_torch" / "scripts" / f"{script}.py").read_text()
    assert "tpu_resiliency." not in text.replace("tpu_resiliency_torch.", "")
    assert "import jax" not in text and "from jax" not in text
