"""The port's mesh (``tpu_resiliency_torch/parallel/mesh.py`` and ``platform/device.py``
``make_mesh``) held against the reference's (``tpu_resiliency/parallel/mesh.py``, on
JAX's 8 virtual CPU devices) and against ``tests/models/test_multihost_mesh.py`` and
the sharded case of ``tests/models/test_transformer.py``: the specs leaf by leaf, the
splits, the checkpoint layout, and ``dp = 2`` and ``tp = 2`` train steps over two gloo
ranks against one process and the reference.
"""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from tests.torch_model_util import numpy_tree, run_gloo
from tpu_resiliency.models import moe as ref_moe
from tpu_resiliency.models import transformer as ref_tfm
from tpu_resiliency.parallel import mesh as ref
from tpu_resiliency_torch.models import transformer as tfm
from tpu_resiliency_torch.parallel import mesh as pm
from tpu_resiliency_torch.platform import device as port_device


def _leaves(specs):
    """``(path, spec)`` pairs; a reference ``PartitionSpec`` as the tuple it is."""
    if isinstance(specs, dict):
        return [(f"{k}/{p}" if p else k, s) for k, v in sorted(specs.items())
                for p, s in _leaves(v)]
    return [("", tuple(specs))]


def test_specs_equal_the_reference_leaf_by_leaf():
    cfg_r, cfg_p = ref_tfm.TransformerConfig.tiny(), tfm.TransformerConfig.tiny()
    assert _leaves(pm.param_specs(cfg_p)) == _leaves(ref.param_specs(cfg_r))
    assert _leaves(pm.moe_param_specs(cfg_p)) == _leaves(ref.moe_param_specs(cfg_r))
    layers = pm.moe_param_specs(cfg_p)["layers"]
    assert _leaves(pm.pipeline_layer_specs(layers)) == _leaves(
        ref.pipeline_layer_specs(ref.moe_param_specs(cfg_r)["layers"]))
    assert tuple(pm.batch_spec()) == tuple(ref.batch_spec())
    assert (pm.DP, pm.TP, pm.SP, pm.PP, pm.EP) == (ref.DP, ref.TP, ref.SP, ref.PP, ref.EP)


@pytest.mark.parametrize("n", range(1, 17))
def test_splits_equal_the_reference(n):
    assert pm.default_split(n) == ref.default_split(n)
    assert pm.moe_pipeline_split(n) == ref.moe_pipeline_split(n)


@pytest.fixture
def one_rank_group():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_names_its_axes_and_refuses_a_wrong_shape(one_rank_group):
    mesh = port_device.make_mesh({"dp": 1, "tp": 1}, device="cpu")
    assert mesh.mesh_dim_names == ("dp", "tp") and tuple(mesh.mesh.shape) == (1, 1)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        port_device.make_mesh({"dp": 2}, device="cpu")
    from tpu_resiliency.platform.device import make_mesh as ref_make_mesh

    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        ref_make_mesh({"dp": 2}, devices=jax.devices()[:1])
    for build in (lambda: pm.build_mesh(dp=2, device="cpu"),
                  lambda: ref.build_mesh(devices=jax.devices()[:1], dp=2)):
        with pytest.raises(ValueError, match=r"dp\*tp\*sp\*pp\*ep = 2 != 1 devices"):
            build()
    mesh = pm.build_mesh(device="cpu")
    assert pm.axis_sizes(mesh) == {"pp": 1, "dp": 1, "ep": 1, "sp": 1, "tp": 1}
    assert pm.axis_sizes(mesh) == ref.axis_sizes(ref.build_mesh(devices=jax.devices()[:1]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_device.make_mesh({"dp": 1})


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        port_device.make_mesh({"dp": 1}, device="cpu")


def _local_tree(cfg, specs, sizes):
    """The tree's local block shapes on a rank of a mesh of ``sizes``, as zeros."""
    shapes = jax.eval_shape(lambda: ref_moe.init_params(jax.random.PRNGKey(0), cfg)
                            if isinstance(cfg, ref_moe.MoEConfig) else
                            ref_tfm.init_params(jax.random.PRNGKey(0), cfg))

    def local(shape, spec):
        return np.zeros([s // (sizes[a] if a else 1) for s, a in zip(shape.shape, spec)],
                        np.float32)

    return jax.tree.map(local, shapes, specs,
                        is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))


MESH_CHILD = """
import numpy as np
from tpu_resiliency_torch.models import transformer as tfm, moe
from tpu_resiliency_torch.parallel import mesh as pm

mesh = pm.build_mesh(device="cpu", **args["split"])
cfg = moe.MoEConfig.tiny() if args["family"] == "moe" else tfm.TransformerConfig.tiny()
specs = pm.moe_param_specs(cfg) if args["family"] == "moe" else pm.param_specs(cfg)
init = moe.init_params if args["family"] == "moe" else tfm.init_params
model = (moe.MoE if args["family"] == "moe" else tfm.Transformer)(cfg, init(0, cfg, device="cpu"))
pm.distribute_model(model, mesh, specs)
local = tfm.nest({n: p.to_local() for n, p in model.named_parameters()})
layout = pm.checkpoint_layout(mesh, local, specs)
result({"layout": layout.to_meta(), "sizes": pm.axis_sizes(mesh)})
"""


@pytest.mark.parametrize("family,split", [("dense", {"tp": 2}), ("dense", {"dp": 2}),
                                          ("moe", {"ep": 2})])
def test_checkpoint_layout_equals_the_reference(family, split):
    """The layout of the port's placed tree on two gloo ranks against the reference's
    ``checkpoint_layout`` on a mesh of the same split over 2 JAX devices."""
    runs = run_gloo(MESH_CHILD, 2, {"family": family, "split": split})
    cfg = ref_moe.MoEConfig.tiny() if family == "moe" else ref_tfm.TransformerConfig.tiny()
    specs = ref.moe_param_specs(cfg) if family == "moe" else ref.param_specs(cfg)
    mesh = ref.build_mesh(devices=jax.devices()[:2], **split)
    sizes = ref.axis_sizes(mesh)
    want = ref.checkpoint_layout(mesh, _local_tree(cfg, specs, sizes), specs).to_meta()
    for r in runs:
        assert r["sizes"] == sizes
        assert r["layout"] == want


TRAIN_CHILD = """
import numpy as np
from tpu_resiliency_torch.models import transformer as tfm
from tpu_resiliency_torch.parallel import mesh as pm

weights = {k: np.load(args["dir"] + "/" + k + ".npy") for k in args["names"]}
cfg = tfm.TransformerConfig.tiny(n_layers=2, dtype=torch.float32)
model = tfm.Transformer(cfg, tfm.params_from_reference(tfm.nest(weights), device="cpu"))
mesh = pm.build_mesh(device="cpu", **args["split"])
pm.distribute_model(model, mesh, pm.param_specs(cfg))
tokens = pm.distribute_batch(torch.from_numpy(np.load(args["dir"] + "/tokens.npy")), mesh)
step, init_opt = tfm.make_train_step(cfg)
opt = init_opt(model)
losses = [float(step(model, opt, tokens)[2]) for _ in range(3)]
wq = model.layers["wq"]
result({"losses": losses, "wq": [repr(p) for p in wq.placements],
        "wq_local": list(wq.to_local().shape),
        "wq_after": wq.full_tensor().detach().numpy().tolist()})
"""


@pytest.mark.parametrize("split", [{"dp": 2}, {"tp": 2}])
def test_sharded_train_step_matches_one_process_and_the_reference(tmp_path, split):
    """As ``test_multihost_mesh.py``: the same global batch (``rng(7)``, [4, 32]) and
    the reference's weights, three train steps; the two ranks agree bit for bit, and
    match one process and the reference within 1e-4 relative (that test's bound)."""
    cfg_r = ref_tfm.TransformerConfig.tiny(n_layers=2, dtype=jnp.float32)
    weights = numpy_tree(ref_tfm.init_params(jax.random.PRNGKey(0), cfg_r))
    tokens = np.random.default_rng(7).integers(0, cfg_r.vocab_size, (4, 32)).astype(np.int64)
    flat = tfm.flat_names(weights)
    for k, v in flat.items():
        np.save(tmp_path / f"{k}.npy", v)
    np.save(tmp_path / "tokens.npy", tokens)
    runs = run_gloo(TRAIN_CHILD, 2, {"dir": str(tmp_path), "names": sorted(flat), "split": split})
    assert runs[0]["losses"] == runs[1]["losses"]
    assert runs[0]["losses"][-1] < runs[0]["losses"][0]
    if "tp" in split:
        assert runs[0]["wq"] == ["Shard(dim=2)"] and runs[0]["wq_local"] == [2, 64, 32]
    else:
        assert runs[0]["wq"] == ["Replicate()"] and runs[0]["wq_local"] == [2, 64, 64]

    model = tfm.Transformer(tfm.TransformerConfig.tiny(n_layers=2, dtype=torch.float32),
                            tfm.params_from_reference(weights, device="cpu"))
    step, init_opt = tfm.make_train_step(model.cfg)
    opt = init_opt(model)
    one = [float(step(model, opt, torch.from_numpy(tokens))[2]) for _ in range(3)]
    np.testing.assert_allclose(runs[0]["losses"], one, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(runs[0]["wq_after"]),
                               model.layers["wq"].detach().numpy(), rtol=1e-4, atol=1e-6)

    step_r, init_r = ref_tfm.make_train_step(cfg_r)
    params, state = weights, init_r(weights)
    want = []
    for _ in range(3):
        params, state, loss = jax.jit(step_r)(params, state, jnp.asarray(tokens, jnp.int32))
        want.append(float(loss))
    np.testing.assert_allclose(runs[0]["losses"], want, rtol=1e-4)


def test_tree_shardings_place_per_spec(one_rank_group):
    """On the mesh of one rank the placements live on its last axis (``tp``, size 1),
    where a shard is the whole leaf."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = pm.build_mesh(device="cpu")
    assert pm.active_mesh(mesh).mesh_dim_names == ("tp",)
    places = pm.tree_shardings(mesh, pm.param_specs(tfm.TransformerConfig.tiny()))
    assert places["layers"]["wq"] == (Shard(2),) and places["layers"]["wo"] == (Shard(1),)
    assert places["layers"]["attn_norm"] == (Replicate(),)
    model = tfm.Transformer(tfm.TransformerConfig.tiny(), device="cpu")
    pm.distribute_model(model, mesh, pm.param_specs(model.cfg))
    assert model.layers["wq"].to_local().shape == model.layers["wq"].shape
