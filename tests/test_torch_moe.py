"""The port's MoE family (``tpu_resiliency_torch/models/moe.py``) held against the
reference (``tpu_resiliency/models/moe.py``, run in this process on JAX's CPU) and
against ``tests/models/test_moe.py``'s own checks, on the reference's weights carried
across: routing (dispatch masks, slot positions, capacity drops) exactly, combine
weights and the aux loss within 1e-6, logits within the stated tolerances, and expert
parallelism (``ep = 2`` over two gloo ranks) against the replicated run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_model_util import numpy_tree, run_gloo
from tpu_resiliency.models import moe as ref
from tpu_resiliency_torch.models import moe
from tpu_resiliency_torch.models import transformer as tfm

#: Float32 logits: the two packages' matmuls sum in other orders.
F32_RTOL, F32_ATOL = 1e-5, 1e-5
#: The router's combine weights and the aux loss.
ROUTE_TOL = 1e-6


@pytest.fixture(scope="module")
def weights():
    return numpy_tree(ref.init_params(jax.random.PRNGKey(0), ref.MoEConfig.tiny()))


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(1).integers(0, 256, (4, 32)).astype(np.int64)


def port_model(weights, **kw):
    return moe.MoE(moe.MoEConfig.tiny(**kw), tfm.params_from_reference(weights, device="cpu"))


def routes(weights, tokens, **kw):
    """Both packages' ``_route`` on the same bf16 activations (the embedding rows)."""
    cfg_r, cfg_p = ref.MoEConfig.tiny(**kw), moe.MoEConfig.tiny(**kw)
    y_r = jnp.asarray(weights["embed"]).astype(cfg_r.dtype)[jnp.asarray(tokens, jnp.int32)]
    want = [np.asarray(a, np.float32) for a in
            ref._route(cfg_r, y_r, jnp.asarray(weights["layers"]["w_router"][0]))]
    y = torch.from_numpy(weights["embed"]).to(cfg_p.dtype)[torch.from_numpy(tokens)]
    got = [a.numpy() for a in moe._route(cfg_p, y, torch.from_numpy(weights["layers"]["w_router"][0]))]
    return cfg_p, got, want


@pytest.mark.parametrize("capacity_factor", [1.5, 8.0, 0.5])
def test_routing_equals_the_reference(weights, tokens, capacity_factor):
    cfg, (dispatch, combine, aux), (d_r, c_r, aux_r) = routes(
        weights, tokens, capacity_factor=capacity_factor)
    B, T = tokens.shape
    assert dispatch.shape == (B, T, cfg.n_experts, cfg.capacity(T))
    np.testing.assert_array_equal(dispatch, d_r)  # masks, slot positions and drops
    np.testing.assert_array_equal(np.argwhere(dispatch), np.argwhere(d_r))
    np.testing.assert_array_equal(dispatch.sum(axis=(2, 3)), d_r.sum(axis=(2, 3)))
    np.testing.assert_allclose(combine, c_r, rtol=ROUTE_TOL, atol=ROUTE_TOL)
    assert abs(float(aux) - float(aux_r)) <= ROUTE_TOL * abs(float(aux_r))


def test_routing_respects_topk_and_capacity(weights, tokens):
    """The reference's invariants, on the port."""
    cfg, (dispatch, combine, aux), _ = routes(weights, tokens)
    assert dispatch.sum(axis=(2, 3)).max() <= cfg.top_k + 1e-6
    assert dispatch.sum(axis=1).max() <= 1 + 1e-6  # each slot holds one token at most
    assert np.where(dispatch == 0, combine, 0.0).max() == 0.0
    assert combine.sum(axis=(2, 3)).max() <= 1 + 1e-5
    assert dispatch.sum(axis=(1, 3)).max() <= cfg.capacity(tokens.shape[1])


def test_generous_capacity_admits_every_token(weights, tokens):
    cfg, (dispatch, combine, _), _ = routes(weights, tokens, capacity_factor=8.0)
    assert dispatch.sum(axis=(2, 3)).min() == pytest.approx(cfg.top_k, abs=1e-6)
    np.testing.assert_allclose(combine.sum(axis=(2, 3)), 1.0, atol=1e-5)


def test_forward_matches_the_reference(weights, tokens):
    with torch.no_grad():
        logits, aux = port_model(weights, dtype=torch.float32)(torch.from_numpy(tokens))
    cfg_r = ref.MoEConfig.tiny(dtype=jnp.float32)
    logits_r, aux_r = ref.forward(weights, jnp.asarray(tokens, jnp.int32), cfg_r)
    assert logits.shape == (*tokens.shape, 256) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_r),
                               rtol=F32_RTOL, atol=F32_ATOL)
    assert abs(float(aux) - float(aux_r)) <= ROUTE_TOL * abs(float(aux_r))
    # Minimized at perfect balance, where it equals top_k (reference check).
    assert float(aux) >= 2 - 1e-2


def test_loss_matches_the_reference(weights, tokens):
    loss = moe.loss_fn(port_model(weights, dtype=torch.float32), torch.from_numpy(tokens),
                       moe.MoEConfig.tiny(dtype=torch.float32))
    loss_r = ref.loss_fn(weights, jnp.asarray(tokens, jnp.int32), ref.MoEConfig.tiny(dtype=jnp.float32))
    assert abs(float(loss.detach()) - float(loss_r)) <= 1e-6 * abs(float(loss_r))


def test_train_step_decreases_loss(weights, tokens):
    model = port_model(weights)
    step, init_opt = moe.make_train_step(model.cfg)
    opt = init_opt(model)
    t = torch.from_numpy(tokens)
    losses = [float(step(model, opt, t)[2]) for _ in range(5)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


EP_CHILD = """
import numpy as np
from tpu_resiliency_torch.models import moe, transformer as tfm
from tpu_resiliency_torch.parallel import mesh as pm

weights = {k: np.load(args["dir"] + "/" + k + ".npy") for k in args["names"]}
cfg = moe.MoEConfig.tiny(dtype=torch.float32)
model = moe.MoE(cfg, tfm.params_from_reference(tfm.nest(weights), device="cpu"))
tokens = torch.from_numpy(np.load(args["dir"] + "/tokens.npy"))
mesh = pm.build_mesh(device="cpu", **args["split"])
pm.distribute_model(model, mesh, pm.moe_param_specs(cfg))
placed = {n: [repr(p) for p in t.placements] for n, t in model.named_parameters()}
logits, aux = model(pm.distribute_batch(tokens, mesh))
step, init_opt = moe.make_train_step(cfg)
opt = init_opt(model)
losses = [float(step(model, opt, pm.distribute_batch(tokens, mesh))[2]) for _ in range(3)]
result({"logits": logits.full_tensor().detach().numpy().tolist(), "aux": float(aux.full_tensor()),
        "losses": losses, "placed": placed})
"""


@pytest.mark.parametrize("split", [{"ep": 2}, {"dp": 2}])
def test_expert_parallel_matches_replicated(weights, tokens, tmp_path, split):
    """``ep = 2`` (experts sharded over two gloo ranks) and ``dp = 2`` against the
    replicated port run and the reference: logits, aux and three train steps."""
    flat = tfm.flat_names(weights)
    for k, v in flat.items():
        np.save(tmp_path / f"{k}.npy", v)
    np.save(tmp_path / "tokens.npy", tokens)
    runs = run_gloo(EP_CHILD, 2, {"dir": str(tmp_path), "names": sorted(flat), "split": split})
    model = port_model(weights, dtype=torch.float32)
    logits, aux = model(torch.from_numpy(tokens))
    step, init_opt = moe.make_train_step(model.cfg)
    opt = init_opt(model)
    losses = [float(step(model, opt, torch.from_numpy(tokens))[2]) for _ in range(3)]
    for r in runs:
        np.testing.assert_allclose(np.asarray(r["logits"]), logits.detach().numpy(),
                                   rtol=F32_RTOL, atol=F32_ATOL)
        assert abs(r["aux"] - float(aux)) <= ROUTE_TOL * abs(float(aux))
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
    assert runs[0]["losses"] == runs[1]["losses"]
    want = "Shard(dim=1)" if "ep" in split else "Replicate()"
    assert runs[0]["placed"]["layers.we_gate"] == [want]
    cfg_r = ref.MoEConfig.tiny(dtype=jnp.float32)
    logits_r, _ = ref.forward(weights, jnp.asarray(tokens, jnp.int32), cfg_r)
    np.testing.assert_allclose(np.asarray(runs[0]["logits"]), np.asarray(logits_r),
                               rtol=F32_RTOL, atol=F32_ATOL)


def test_entry_points_default_to_the_card():
    cfg = moe.MoEConfig.tiny()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            moe.MoE(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            moe.init_params(0, cfg)
    model = moe.MoE(cfg, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    assert sorted(dict(model.named_parameters())) == sorted(
        ["embed", "final_norm", "lm_head"] + [f"layers.{k}" for k in (
            "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_router", "we_gate",
            "we_up", "we_down")])
