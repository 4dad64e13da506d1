"""The port's warm spares, held against ``tests/launcher/test_warm_spares.py``: each of
its tests runs here on ``tpu_resiliency_torch.launcher.park`` (``torch_port_tests``):
the shim, the pool, the park depths, the runtime warmup (the port's
``warm_runtime``) and a restart round promoted from a spare through the port's CLI.
Beside them: a spare preloads ``torch`` by default, and the runtime warmup imports the
port's packages and creates no CUDA context (on the card, ``gpu``: it opens the built
kernel libraries and ``torch.cuda.is_initialized()`` stays False).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from tests.torch_port_tests import REPO, port_tests

port_tests("tests/launcher/test_warm_spares.py", globals(), edits=[
    ("        import tpu_resiliency\n\n        repo_root",
     "        import tpu_resiliency_torch\n\n        repo_root",
     "the rewrite names the port's package in the next line; import it"),
])


def test_spares_preload_torch_by_default():
    import inspect

    from tpu_resiliency_torch.launcher.park import WarmSparePool, spawn_spare

    assert inspect.signature(spawn_spare).parameters["preload"].default == "torch"
    assert inspect.signature(WarmSparePool).parameters["preload"].default == "torch"


WARM = """
import json, sys, torch
from tpu_resiliency_torch.platform.device import WARM_MODULES, warm_runtime
info = warm_runtime()
print(json.dumps({"info": info, "cuda_initialized": torch.cuda.is_initialized(),
                  "imported": all(m in sys.modules for m in WARM_MODULES),
                  "jax": any(m == "jax" or m.startswith("jax.") for m in sys.modules)}))
"""


def _warm(env=None):
    r = subprocess.run([sys.executable, "-c", WARM], capture_output=True, text=True,
                       timeout=300, cwd=str(REPO), env=dict(os.environ, **(env or {}),
                                                            PYTHONPATH=str(REPO)))
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_runtime_warmup_imports_the_port_and_creates_no_cuda_context():
    got = _warm()
    assert got["imported"] and not got["jax"]
    assert got["cuda_initialized"] is False and got["info"]["cuda_initialized"] is False
    assert got["info"]["cpu_init"] is True


@pytest.mark.gpu
def test_runtime_warmup_on_the_card_opens_the_kernels_and_no_context():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpu_resiliency_torch.ops import _build
    from tpu_resiliency_torch.ops.scoring_kernels import KERNEL_NAMES

    _build.build(KERNEL_NAMES.values())
    got = _warm()
    assert got["cuda_initialized"] is False
    assert set(KERNEL_NAMES.values()) <= set(got["info"]["kernels_loaded"])
