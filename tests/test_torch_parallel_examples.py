"""The port's three parallel-path examples, held against the reference's:

- ``tpu_resiliency_torch/examples/moe_pipeline_training.py`` on 4 gloo ranks
  (``moe_pipeline_split(4)``: pp = 2 x ep = 2) against
  ``tests/inprocess/test_moe_pipeline_example.py``: ``RESUMED step=3`` and ``DONE
  loss=`` after a fault at step 3;
- ``examples/inprocess_restart_train.py`` and the port's, run one after the other
  (``scheduled_first``, as the port's hang test runs its pair): rank 0's record must
  give the reference's ``iteration``, ``active_world`` and ``resumed_from``; the
  port's MLP step is held in-process against the reference's jitted ``step_fn`` on
  the same numpy weights and data at rtol 1e-6;
- ``examples/mesh_telemetry_training.py`` under the port's launcher with 2 workers, as
  ``tests/telemetry/test_mesh_multiprocess.py``'s
  ``test_mesh_telemetry_example_under_launcher`` runs the reference's.

That each runs on the card by default is held in ``tests/test_torch_imports.py``.
"""

import ast
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_inprocess_faults import scheduled_first
from tests.torch_port_tests import REPO
from tpu_resiliency_torch.examples import inprocess_restart_train as port_inproc


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
                TPU_RESILIENCY_LOG_LEVEL="WARNING")


def _run(argv, timeout=240, **kw):
    return subprocess.run([sys.executable, *argv], capture_output=True, text=True,
                          timeout=timeout, env=kw.pop("env", _env()), cwd=str(REPO), **kw)


def test_moe_pipeline_example_restarts_and_resumes(tmp_path):
    proc = _run(["-m", "tpu_resiliency_torch.examples.moe_pipeline_training", "--world", "4",
                 "--device", "cpu", "--steps", "8", "--fault-step", "3", "--ckpt-root",
                 str(tmp_path)], timeout=300)
    out = proc.stdout
    assert proc.returncode == 0, f"stdout:\n{out}\nstderr:\n{proc.stderr[-3000:]}"
    # Fault at step 3 after the step-2 checkpoint: the restart resumes at step 3.
    assert "RESUMED step=3" in out, out
    assert "DONE loss=" in out, out


def _results(out: str) -> dict:
    line = [ln for ln in out.splitlines() if ln.startswith("results:")][0]
    return ast.literal_eval(line[len("results:"):].strip())


#: Both examples' run: rank 1 dies at step 6 (their default); a step of 1 s puts the
#: next save 1 s after the death, so the restart lands between the saves at 4 and 6
#: in both packages. At the default 0.25 s it raced the step-6 save, and on a loaded
#: host the reference and the port resumed at 5 or 7 by timing alone.
INPROC_ARGS = ["--world", "2", "--steps", "8", "--step-time", "1.0"]


def test_inprocess_restart_example_resumes_as_the_reference(tmp_path):
    with scheduled_first():
        ref = _run([str(REPO / "examples" / "inprocess_restart_train.py"), *INPROC_ARGS,
                    "--ckpt-root", str(tmp_path / "ref")])
        port = _run(["-m", "tpu_resiliency_torch.examples.inprocess_restart_train",
                     *INPROC_ARGS, "--device", "cpu", "--ckpt-root", str(tmp_path / "port")])
    assert ref.returncode == 0, ref.stdout[-2000:] + ref.stderr[-2000:]
    assert port.returncode == 0, port.stdout[-2000:] + port.stderr[-2000:]
    assert "RESTART-RESUME OK" in ref.stdout and "RESTART-RESUME OK" in port.stdout
    want, got = _results(ref.stdout), _results(port.stdout)
    assert sorted(got) == sorted(want) == [0]  # rank 1 died, rank 0 survived
    keys = ("rank", "iteration", "active_world", "resumed_from")
    assert {k: got[0][k] for k in keys} == {k: want[0][k] for k in keys}
    assert set(want[0]) <= set(got[0]) and got[0]["local_devices"] == 1


def _reference_step_fn():
    """The reference example's ``step_fn``, as its ``train`` defines it."""

    @jax.jit
    def step_fn(params, x, y):
        def loss_fn(p):
            h = jnp.tanh(x @ p["w1"])
            pred = h @ p["w2"]
            return jnp.mean((pred - y) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        new = jax.tree_util.tree_map(lambda p, g: p - 0.1 * g, params, grads)
        return new, loss

    return step_fn


def test_mlp_step_matches_the_reference_step_fn():
    """Ten steps from the same numpy weights on the example's seeded data (rank 0's
    ``rng(123)``): parameters and losses within rtol 1e-6."""
    ref_step = _reference_step_fn()
    w = np.random.default_rng(5)
    params = {"w1": (w.standard_normal((16, 32)) * 0.1).astype(np.float32),
              "w2": (w.standard_normal((32, 1)) * 0.1).astype(np.float32)}
    ref_p = {k: jnp.asarray(v) for k, v in params.items()}
    port_p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    rng = np.random.default_rng(123)
    for _ in range(10):
        x = rng.standard_normal((8, 16)).astype(np.float32)
        y = rng.standard_normal((8, 1)).astype(np.float32)
        ref_p, ref_loss = ref_step(ref_p, jnp.asarray(x), jnp.asarray(y))
        port_p, port_loss = port_inproc.step_fn(port_p, torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(float(port_loss), float(ref_loss), rtol=1e-6)
        for k in params:
            np.testing.assert_allclose(port_p[k].numpy(), np.asarray(ref_p[k]), rtol=1e-6,
                                       atol=1e-7)


def test_mesh_telemetry_example_under_launcher(tmp_path):
    """The example asserts its report rounds made zero per-rank store gets and that the
    injected slow rank was flagged."""
    env = dict(_env(), TPU_RESILIENCY_LOG_LEVEL="INFO")
    r = _run(["-m", "tpu_resiliency_torch.launcher.launch", "--nproc-per-node", "2",
              "--no-ft-monitors", "--rdzv-endpoint", f"127.0.0.1:{free_port()}",
              "--rdzv-last-call", "0.2", "--monitor-interval", "0.1",
              "--run-dir", str(tmp_path / "run"),
              str(REPO / "tpu_resiliency_torch" / "examples" / "mesh_telemetry_training.py"),
              "--device", "cpu", "--steps", "150"], env=env)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr[-4000:]}"
    assert "ZERO-GATHER OK" in r.stdout
    assert "flagged ranks [1]" in r.stdout
