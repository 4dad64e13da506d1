"""``tpu_resiliency_torch/scripts/bench_restart.py`` held against the reference's
``scripts/bench_restart.py``: the reference's own test (``tests/test_bench_restart.py``)
runs on the port through ``torch_port_tests`` (its three perf gates stay ``slow``), the
port's ``--smoke`` runs in tier-1, and the options and keys are the reference's.

The edits to the reference's test, each to reach the port on the CPU (its entry points
run on the card by default):

- the script it starts is ``-m tpu_resiliency_torch.scripts.bench_restart --device cpu``;
- the slow tests import the legs from the port's module;
- ``bench_compile_cache`` is called with ``"cpu"``: its worker compiles on the card by
  default.
"""

import importlib.util
import json
import subprocess
import sys

import pytest
import torch

from tests.torch_port_tests import REPO, port_tests
from tpu_resiliency_torch.scripts import bench_restart

PORT_MODULE = "tpu_resiliency_torch.scripts.bench_restart"
WHY = "the port's module, on the CPU: its default is the card"

port_tests(
    "tests/test_bench_restart.py", globals(),
    edits=[
        ('os.path.join(REPO, "scripts", "bench_restart.py"),',
         f'"-m", "{PORT_MODULE}", "--device", "cpu",', WHY),
        ("from scripts.bench_restart import bench_injob, bench_inprocess",
         f"from {PORT_MODULE} import bench_injob, bench_inprocess", WHY),
        ("from scripts.bench_restart import bench_rendezvous_fastpath",
         f"from {PORT_MODULE} import bench_rendezvous_fastpath", WHY),
        ("from scripts.bench_restart import bench_compile_cache",
         f"from {PORT_MODULE} import bench_compile_cache", WHY),
        ("r = bench_compile_cache()", 'r = bench_compile_cache("cpu")', WHY),
    ],
)


def _reference_module():
    spec = importlib.util.spec_from_file_location("ref_bench_restart",
                                                  REPO / "scripts" / "bench_restart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_options_are_the_references_and_the_device():
    import argparse

    ref = _reference_module()
    captured = {}
    real = argparse.ArgumentParser.parse_args

    class Stop(Exception):
        pass

    def grab(self, args=None, namespace=None):
        captured.update(vars(real(self, [], namespace)))
        raise Stop

    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(Stop):
            ref.main()
    finally:
        argparse.ArgumentParser.parse_args = real
    port = vars(bench_restart.parse_args([]))
    assert sorted(set(port) - set(captured)) == ["device"]
    assert {k: port[k] for k in captured if k != "out"} == {
        k: v for k, v in captured.items() if k != "out"}
    # The port writes its file under the checkout's build/, never over the reference's.
    assert port["out"].endswith("BENCH_restart.json") and "/build/" in port["out"]


def test_the_workers_are_the_references_but_for_the_compiler():
    ref = _reference_module()
    assert bench_restart.WORKER == ref.WORKER
    assert "torch.compile(lambda x: torch.tanh(x @ x.T).sum())" in bench_restart.JIT_WORKER
    assert "torch.ones((256, 256), dtype=torch.float32" in bench_restart.JIT_WORKER


def test_smoke_passes_on_the_cpu():
    proc = subprocess.run([sys.executable, "-m", PORT_MODULE, "--smoke", "--device", "cpu"],
                          cwd=str(REPO), capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert lines[-1] == {"bench_restart_smoke": "PASS", "backend": "cpu", "device_kind": "cpu",
                         "card": None}
    layers = {rec["layer"]: rec for rec in lines[:-1]}
    assert set(layers) == {"in-job-warm", "rendezvous-fastpath", "compile-cache"}
    cache = layers["compile-cache"]
    assert cache["outcomes"] == ["miss", "hit"]
    # The CPU's torch.compile writes Inductor's C++ artifacts and no Triton cache.
    assert cache["manifest_entries"]["inductor"] > 0 and cache["manifest_entries"]["triton"] == 0


def test_compile_cache_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        assert bench_restart.bench_compile_cache()["restart_hit"]
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_restart.main(["--smoke"])
