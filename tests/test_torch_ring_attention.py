"""The port's ring attention (``tpu_resiliency_torch/parallel/ring_attention.py``) and
its differentiable neighbour shift (``parallel/p2p.py``), held against the reference's
``tpu_resiliency/parallel/ring_attention.py`` on JAX's 8 virtual CPU devices and
against ``tests/models/test_ring_attention.py``'s tolerances.

Each world is a set of fresh gloo interpreters (``tests/torch_model_util.py``
``run_gloo``), run once per module:

- 2 ranks: the shift with n = 2 (next and previous are the same peer), and the ring
  at sp = 2;
- 4 ranks: the shift with n = 4, the ring at sp = 4 and at sp = 2 x tp = 2, and the
  transformer's loss and gradients with ``attn_fn=ring`` at sp = 2 x tp = 2.

The ring's output must match the reference's ring on a mesh of the same split, and
the dense ``_attention``, at rtol/atol 2e-5 (the reference test's bound) and stay
sequence-sharded; the loss within 1e-5 relative and every gradient leaf within rtol
5e-4, atol 5e-5 of the reference's dense ``value_and_grad``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tests.torch_model_util import numpy_tree, run_gloo
from tpu_resiliency.models import transformer as ref_tfm
from tpu_resiliency.parallel import ring_attention as ref_ring
from tpu_resiliency_torch.models import transformer as tfm
from tpu_resiliency_torch.parallel import ring_attention as port_ring

QKV_SHAPE = (4, 32, 4, 16)  # b, t, h, dh: the reference test's


def qkv():
    rng = np.random.default_rng(0)
    return [rng.standard_normal(QKV_SHAPE).astype(np.float32) for _ in range(3)]


CHILD = """
import numpy as np
from torch.distributed.tensor import distribute_tensor
from tpu_resiliency_torch.models import transformer as tfm
from tpu_resiliency_torch.parallel import mesh as pm, p2p
from tpu_resiliency_torch.parallel.ring_attention import make_ring_attn_fn

out = {}
# The shift: rank r sends x_r on, and the gradient of sum(w_r * y_r) comes back.
x = torch.tensor(np.random.default_rng(100 + rank).standard_normal((3, 5)),
                 dtype=torch.float32, requires_grad=True)
w = torch.tensor(np.random.default_rng(200 + rank).standard_normal((3, 5)), dtype=torch.float32)
aux = torch.tensor(float(rank), requires_grad=True)
y, y_aux = p2p.shift([x, aux], dist.group.WORLD)
((y * w).sum() + 3.0 * y_aux).backward()
out["shift"] = {"y": y.tolist(), "y_aux": float(y_aux), "grad": x.grad.tolist(),
                "aux_grad": float(aux.grad)}

rng = np.random.default_rng(0)
q, k, v = (torch.tensor(rng.standard_normal(args["qkv_shape"]), dtype=torch.float32)
           for _ in range(3))
for name, split in args["splits"].items():
    mesh = pm.build_mesh(device="cpu", **split)
    sub = pm.active_mesh(mesh)
    places = pm.placements(sub, ("dp", "sp", "tp", None))
    ring = make_ring_attn_fn(mesh)(*(distribute_tensor(t, sub, places) for t in (q, k, v)))
    out[name] = {"placements": [repr(p) for p in ring.placements],
                 "local": list(ring.to_local().shape), "full": ring.full_tensor().tolist()}

if "model" in args:
    import time
    t0 = time.perf_counter()
    names = args["model"]["names"]
    weights = {n: np.load(args["model"]["dir"] + "/" + n + ".npy") for n in names}
    cfg = tfm.TransformerConfig.tiny(n_layers=2, dtype=torch.float32)
    model = tfm.Transformer(cfg, tfm.params_from_reference(tfm.nest(weights), device="cpu"))
    mesh = pm.build_mesh(device="cpu", **args["model"]["split"])
    pm.distribute_model(model, mesh, pm.param_specs(cfg))
    tokens = pm.distribute_batch(
        torch.from_numpy(np.load(args["model"]["dir"] + "/tokens.npy")), mesh)
    with tfm.sharding_context(model):
        loss = tfm.loss_fn(model, tokens, cfg, attn_fn=make_ring_attn_fn(mesh))
        loss.backward()
    grads = {n: p.grad.full_tensor().numpy() for n, p in model.named_parameters()}
    if rank == 0:
        for n, g in grads.items():
            np.save(args["model"]["dir"] + "/grad_" + n + ".npy", g)
    out["model"] = {"loss": float(loss.full_tensor()), "seconds": time.perf_counter() - t0}
result(out)
"""


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    """The reference's tiny f32 weights (``PRNGKey(1)``) and tokens (``rng(1)``, [4, 32])
    as ``.npy`` files; the reference's dense loss and gradients."""
    d = tmp_path_factory.mktemp("ring_model")
    cfg = ref_tfm.TransformerConfig.tiny(n_layers=2, dtype=jnp.float32)
    params = ref_tfm.init_params(jax.random.PRNGKey(1), cfg)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 32))
    flat = tfm.flat_names(numpy_tree(params))
    for k, v in flat.items():
        np.save(d / f"{k}.npy", v)
    np.save(d / "tokens.npy", tokens.astype(np.int64))
    loss, grads = jax.value_and_grad(ref_tfm.loss_fn)(params, jnp.asarray(tokens, jnp.int32), cfg)
    return {"dir": str(d), "names": sorted(flat), "loss": float(loss),
            "grads": tfm.flat_names(numpy_tree(grads))}


@pytest.fixture(scope="module")
def worlds(model_files):
    two = run_gloo(CHILD, 2, {"qkv_shape": QKV_SHAPE, "splits": {"sp2": {"sp": 2}}}, threads=4)
    four = run_gloo(CHILD, 4, {
        "qkv_shape": QKV_SHAPE,
        "splits": {"sp4": {"sp": 4}, "sp2_tp2": {"sp": 2, "tp": 2}},
        "model": {"dir": model_files["dir"], "names": model_files["names"],
                  "split": {"sp": 2, "tp": 2}},
    }, threads=2)
    return {2: two, 4: four}


@pytest.mark.parametrize("n", [2, 4])
def test_shift_rotates_forward_and_its_gradient_rotates_back(worlds, n):
    """Rank r receives rank r - 1's tensors; the gradient of ``sum(w_r * y_r)`` at rank
    r is rank r + 1's ``w``: the reverse rotation (what JAX derives for ``ppermute``)."""
    runs = worlds[n]
    x = [np.random.default_rng(100 + r).standard_normal((3, 5)).astype(np.float32)
         for r in range(n)]
    w = [np.random.default_rng(200 + r).standard_normal((3, 5)).astype(np.float32)
         for r in range(n)]
    for r, run in enumerate(runs):
        s = run["shift"]
        np.testing.assert_array_equal(np.asarray(s["y"], np.float32), x[(r - 1) % n])
        np.testing.assert_array_equal(np.asarray(s["grad"], np.float32), w[(r + 1) % n])
        assert s["y_aux"] == float((r - 1) % n) and s["aux_grad"] == 3.0


def _reference_ring(dp, sp, tp):
    devs = np.asarray(jax.devices()[: dp * sp * tp]).reshape(dp, sp, tp)
    mesh = Mesh(devs, ("dp", "sp", "tp"))
    spec = NamedSharding(mesh, P("dp", "sp", "tp", None))
    q, k, v = (jax.device_put(jnp.asarray(x), spec) for x in qkv())
    return np.asarray(jax.jit(ref_ring.make_ring_attn_fn(mesh))(q, k, v))


@pytest.mark.parametrize("world,name,split,placements", [
    (2, "sp2", (1, 2, 1), ["Shard(dim=1)"]),
    (4, "sp4", (1, 4, 1), ["Shard(dim=1)"]),
    (4, "sp2_tp2", (1, 2, 2), ["Shard(dim=1)", "Shard(dim=2)"]),
])
def test_ring_matches_the_reference_ring_and_dense_attention(worlds, world, name, split,
                                                             placements):
    q, k, v = qkv()
    dense = np.asarray(ref_tfm._attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    want = _reference_ring(*split)
    for run in worlds[world]:
        got = np.asarray(run[name]["full"], np.float32)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, dense, rtol=2e-5, atol=2e-5)
        # The output stays sequence-sharded: no hidden full replication.
        assert run[name]["placements"] == placements
        assert run[name]["local"][1] == QKV_SHAPE[1] // split[1]


def test_port_block_of_one_equals_the_reference_block_on_one_device():
    """sp = 1 (what the card runs): the port's block with no ring against the
    reference's ``_ring_block`` under a one-device ``shard_map``, causal and not."""
    q, k, v = qkv()
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1), ("dp", "sp", "tp"))
    for causal in (True, False):
        want = np.asarray(jax.jit(ref_ring.make_ring_attn_fn(mesh, causal=causal))(
            *(jnp.asarray(x) for x in (q, k, v))))
        got = port_ring._ring_block(*(torch.from_numpy(x) for x in (q, k, v)), group=None,
                                    causal=causal)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    assert port_ring.NEG_INF == ref_ring.NEG_INF


def test_forward_and_grads_match_dense(worlds, model_files):
    """The transformer's loss and gradients with ``attn_fn=ring`` over sp = 2 x tp = 2
    against the reference's dense ``value_and_grad`` on the same weights and tokens."""
    for run in worlds[4]:
        np.testing.assert_allclose(run["model"]["loss"], model_files["loss"], rtol=1e-5)
    for name, want in model_files["grads"].items():
        got = np.load(f"{model_files['dir']}/grad_{name}.npy")
        np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-5, err_msg=name)
