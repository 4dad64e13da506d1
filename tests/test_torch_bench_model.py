"""``tpu_resiliency_torch/scripts/bench_model.py`` held against the reference's
``scripts/bench_model.py``: the same options and defaults, the same model for the same
options (its parameter count from the reference's ``init_params`` shapes), one JSON
line with the reference's keys (``mfu_vs_v5e_peak`` answered by ``mfu``), no device
metric from a CPU run, and the card by default."""

import dataclasses
import importlib.util
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_tests import REPO
from tpu_resiliency.models import transformer as ref_tfm
from tpu_resiliency_torch.scripts import bench_model

TINY = ["--layers", "2", "--d-model", "64", "--heads", "4", "--kv-heads", "2", "--d-ff", "128",
        "--vocab", "256", "--batch", "2", "--seq", "32", "--iters", "2"]


def _reference_parser_defaults() -> dict:
    """The reference script's options and defaults, read from its parser (its ``main``
    parses ``sys.argv``; the run stops at the first statement after parsing)."""
    spec = importlib.util.spec_from_file_location("ref_bench_model",
                                                  REPO / "scripts" / "bench_model.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    captured = {}

    class Stop(Exception):
        pass

    import argparse

    real = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        captured.update(vars(real(self, [], namespace)))
        raise Stop

    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(Stop):
            mod.main()
    finally:
        argparse.ArgumentParser.parse_args = real
    return captured


def _reference_n_params(cfg) -> int:
    shapes = jax.eval_shape(lambda: ref_tfm.init_params(jax.random.PRNGKey(0), cfg))
    return sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))


def test_options_and_defaults_are_the_references():
    ref = _reference_parser_defaults()
    port = vars(bench_model.parse_args([]))
    assert {k: port[k] for k in ref} == ref
    assert sorted(set(port) - set(ref)) == ["config", "device"]


def test_cpu_run_prints_one_line_with_the_reference_count_and_no_device_metric():
    proc = subprocess.run([sys.executable, "-m", "tpu_resiliency_torch.scripts.bench_model",
                           *TINY, "--device", "cpu"], cwd=str(REPO), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    cfg = ref_tfm.TransformerConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                                    n_kv_heads=2, d_ff=128, max_seq_len=32)
    assert rec["n_params"] == _reference_n_params(cfg)
    assert rec["n_matmul_params"] == rec["n_params"] - 256 * 64
    reference_keys = {"metric", "value", "unit", "ms_per_step", "final_loss", "backend"}
    assert reference_keys <= set(rec) and "mfu_vs_v5e_peak" not in rec
    assert rec["backend"] == "cpu" and rec["mfu"] is None and rec["mfu_matmul"] is None
    assert rec["timer"] == "host_clock" and rec["unit"] == "tokens/s" and rec["value"] > 0
    assert np.isfinite(rec["final_loss"])


def test_llama_config_is_the_references_at_two_layers():
    """``--config llama3_8b --layers 2``: the width ``model_path`` trains, 1,486,901,248
    parameters in the reference's tree."""
    cfg = bench_model.config(bench_model.parse_args(["--config", "llama3_8b", "--layers", "2"]))
    ref = dataclasses.replace(ref_tfm.TransformerConfig.llama3_8b(), n_layers=2)
    for field in ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads", "d_ff",
                  "rope_theta"):
        assert getattr(cfg, field) == getattr(ref, field), field
    assert _reference_n_params(ref) == 1_486_901_248
    assert cfg.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16


def test_runs_on_the_card_by_default():
    args = bench_model.parse_args(TINY)
    if torch.cuda.is_available():
        rec = bench_model.run(args)
        assert rec["backend"] == "cuda" and rec["timer"] == "cuda_events" and rec["mfu"] > 0
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_model.run(args)
