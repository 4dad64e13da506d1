"""The port's entry points (``tpu_resiliency_torch/__graft_entry__.py``) held against
the repo root's ``__graft_entry__.py``, the reference, on the CPU.

- ``entry(device="cpu")``: the forward of the tiny transformer, run on the reference's
  weights (carried across by ``models/transformer.py`` ``params_from_reference``),
  against the reference's ``entry()`` forward on the same weights.
- ``dryrun_multichip(4, device="cpu")`` (4 gloo processes) against the reference's
  ``dryrun_multichip(4)`` on 4 of JAX's 8 virtual CPU devices (``tests/conftest.py``):
  n = 4 gives dp 2 x tp 2 for the train step and pp 2 x ep 2 for the MoE pipeline.
  Both runs use the reference's weights. The step's loss and the MoE pipeline's loss
  lie within ``LOSS_RTOL`` of the reference's printed losses, the telemetry mask
  equals the truth, the checkpoint round trip is exact, and every ``OK`` line of the
  reference has its counterpart.

The models compute in bfloat16, so the tolerances are bf16 ones: ``LOGITS_RTOL``
relative on the logits' norm, ``LOSS_RTOL`` on each loss. The control is the same computation on
the weights rounded to float8_e5m2 (the reference's forward and loss in JAX), which
must lie outside it: a tolerance that admits other weights would show nothing.
"""

import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tests.torch_model_util import numpy_tree
from tpu_resiliency.models import moe as ref_moe
from tpu_resiliency.models import transformer as ref_tfm
from tpu_resiliency_torch import __graft_entry__ as port
from tpu_resiliency_torch.models import transformer as tfm

REPO = __import__("pathlib").Path(__file__).resolve().parents[1]

#: Relative tolerances of the bf16 models against the reference's: on the logits' norm,
#: and on a loss (a mean over every position, so closer). The losses are printed with
#: four decimals, well inside it. Measured on this CPU: the logits 1.02e-2 apart (their
#: e5m2 control 0.19); the dense step's loss 1.3e-4 (its control 1.6e-2), the MoE
#: pipeline's 1.1e-4 (its control 1.3e-2).
LOGITS_RTOL = 2e-2
LOSS_RTOL = 5e-3


def load_reference_entry():
    import importlib.util

    spec = importlib.util.spec_from_file_location("__graft_entry__", REPO / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def e5m2(tree):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(ml_dtypes.float8_e5m2).astype(a.dtype),
                        tree)


def rel(value, ref) -> float:
    value, ref = np.asarray(value, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(value - ref) / np.linalg.norm(ref))


def test_entry_forward_matches_the_reference():
    ref = load_reference_entry()
    ref_fn, (ref_params, ref_tokens) = ref.entry()
    want = np.asarray(ref_fn(ref_params, ref_tokens), np.float32)
    control = np.asarray(ref_fn(e5m2(ref_params), ref_tokens), np.float32)

    fn, (model, tokens) = port.entry(device="cpu")
    assert tokens.shape == (2, 32) and tokens.dtype == torch.int64 and not tokens.any()
    assert tuple(fn(model, tokens).shape) == want.shape == (2, 32, 256)
    carried = tfm.Transformer(model.cfg, tfm.params_from_reference(numpy_tree(ref_params),
                                                                   device="cpu"))
    with torch.no_grad():
        got = fn(carried, tokens).numpy()
    assert rel(got, want) <= LOGITS_RTOL < rel(control, want), (rel(got, want),
                                                              rel(control, want))


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the card is here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.dryrun_multichip(2)


def reference_weights(tmp_path):
    """The reference's seed-0 weights of both families, written as the port's dry run
    reads them; returns the directory and the two trees."""
    dense = ref_tfm.init_params(jax.random.PRNGKey(0), ref_tfm.TransformerConfig.tiny())
    moe = ref_moe.init_params(jax.random.PRNGKey(0), ref_moe.MoEConfig.tiny())
    for name, tree in (("dense", dense), ("moe", moe)):
        np.savez(tmp_path / f"{name}.npz", **tfm.flat_names(numpy_tree(tree)))
    return tmp_path, dense, moe


LINE = re.compile(r"^dryrun_multichip (OK|SKIP)( \(([\w+-]+)\))?:(.*)$", re.M)


def dryrun_lines(text: str) -> dict:
    return {m.group(3) or "step": m.group(4).strip() for m in LINE.finditer(text)}


def printed_loss(line: str) -> float:
    return float(re.search(r"loss=([-\d.]+)", line).group(1))


def run_both(n, tmp_path, capsys):
    weights, dense, moe = reference_weights(tmp_path)
    load_reference_entry().dryrun_multichip(n)
    ref_lines = dryrun_lines(capsys.readouterr().out)
    got = port.dryrun_multichip(n, device="cpu", weights=weights)
    port_lines = dryrun_lines(capsys.readouterr().out)
    return ref_lines, port_lines, got, dense, moe


def check_against_reference(n, split, moe_split, ref_lines, port_lines, got, dense, moe):
    assert sorted(port_lines) == sorted(ref_lines)
    assert got["split"] == split and got["moe_split"] == moe_split
    assert {k: v for k, v in got["mesh"].items() if v > 1} == {
        k: v for k, v in split.items() if v > 1}
    assert port_lines["step"].split(" loss=")[0] == ref_lines["step"].split(" loss=")[0]
    for key in ("local-ckpt", "replication-remirror"):
        assert port_lines[key] == ref_lines[key]

    zeros = jnp.zeros((split["dp"] * 2, 64), jnp.int32)
    cfg = ref_tfm.TransformerConfig.tiny()
    ref_loss = printed_loss(ref_lines["step"])
    control = float(ref_tfm.loss_fn(e5m2(dense), zeros, cfg))
    assert abs(got["loss"] - ref_loss) <= LOSS_RTOL * abs(ref_loss) < abs(control - ref_loss), (
        got["loss"], ref_loss, control)
    assert printed_loss(port_lines["step"]) == round(got["loss"], 4)

    mzeros = jnp.zeros((moe_split["dp"] * 2 * 2, 64), jnp.int32)
    mcfg = ref_moe.MoEConfig.tiny()
    ref_mloss = printed_loss(ref_lines["moe+pipeline"])
    mcontrol = float(ref_moe.loss_fn(e5m2(moe), mzeros, mcfg))
    assert (abs(got["moe_loss"] - ref_mloss) <= LOSS_RTOL * abs(ref_mloss)
            < abs(mcontrol - ref_mloss)), (got["moe_loss"], ref_mloss, mcontrol)

    tel = got["telemetry"]
    assert tel["mask"] == tel["truth"] == [r == n - 2 for r in range(n)]
    assert tel["kernel_mode"] is None  # the sort path on the CPU
    assert all(ck == {"latest": 3, "leaves": ck["leaves"], "bits_equal": True, "differ": [],
                      "placements_equal": True} for ck in got["local_ckpt"])
    assert got["local_ckpt"][0]["leaves"] == 3 * 12
    assert got["collectives"], "the sharded step issued no collective"


def test_dryrun_multichip_matches_the_reference_on_four_ranks(tmp_path, capsys):
    ref_lines, port_lines, got, dense, moe = run_both(4, tmp_path, capsys)
    check_against_reference(4, {"dp": 2, "tp": 2, "sp": 1, "pp": 1, "ep": 1},
                            {"dp": 1, "tp": 1, "sp": 1, "pp": 2, "ep": 2},
                            ref_lines, port_lines, got, dense, moe)


@pytest.mark.slow
def test_dryrun_multichip_matches_the_reference_on_eight_ranks(tmp_path, capsys):
    """n = 8: dp 2 x tp 2 x sp 2, so attention runs as a ring over sp."""
    ref_lines, port_lines, got, dense, moe = run_both(8, tmp_path, capsys)
    check_against_reference(8, {"dp": 2, "tp": 2, "sp": 2, "pp": 1, "ep": 1},
                            {"dp": 2, "tp": 1, "sp": 1, "pp": 2, "ep": 2},
                            ref_lines, port_lines, got, dense, moe)
