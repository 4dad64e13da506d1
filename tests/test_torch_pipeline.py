"""The port's pipeline schedule (``tpu_resiliency_torch/parallel/pipeline.py``) held
against ``tests/models/test_pipeline.py`` and the stage hop of
``tests/models/test_multihost_mesh.py`` (``test_pipeline_stage_hop_spans_two_processes``),
with the reference's models (``tpu_resiliency/models``) run in-process on JAX's CPU
devices as the oracle and their weights carried across
(``transformer.params_from_reference``).

Two worlds of fresh gloo interpreters (``tests/torch_model_util.py`` ``run_gloo``),
each run once per module:

- 4 ranks: f32 dense at pp = 2 x tp = 2 with ``n_micro`` 4 (loss within 1e-5, every
  gradient leaf's max error under 1e-4 of its largest value); pp = 4 with ``n_micro``
  3; the bf16 model at pp = 2 x tp = 2 within 0.05; the MoE at
  ``moe_pipeline_split(4)`` (pp = 2 x ep = 2): the aux-free loss within 1e-4, one
  finite train step, with the router aux within 0.02; the checkpoint layout of the
  pp-sharded tree; ``_check_pipeline_mesh``'s errors;
- 2 ranks, one stage each: three MoE train steps whose losses agree on both ranks,
  fall, and start within 0.05 of the reference's unpipelined aux-free loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_model_util import numpy_tree, run_gloo
from tpu_resiliency.models import moe as ref_moe
from tpu_resiliency.models import transformer as ref_tfm
from tpu_resiliency.parallel import mesh as ref_mesh
from tpu_resiliency_torch.models import transformer as tfm

CHILD = """
import time
import numpy as np
from tpu_resiliency_torch.models import moe, transformer as tfm
from tpu_resiliency_torch.parallel import mesh as pm, pipeline as pl

d = args["dir"]
out = {}


def load(case, family):
    w = {n: np.load(f"{d}/{case}/{n}.npy") for n in args["cases"][case]["names"]}
    params = tfm.params_from_reference(tfm.nest(w), device="cpu")
    kw = dict(args["cases"][case]["cfg"])
    kw["dtype"] = getattr(torch, kw["dtype"])
    if family == "moe":
        cfg = moe.MoEConfig.tiny(**kw)
        return cfg, moe.MoE(cfg, params), pm.moe_param_specs(cfg)
    cfg = tfm.TransformerConfig.tiny(**kw)
    return cfg, tfm.Transformer(cfg, params), pm.param_specs(cfg)


def placed(case, family, split):
    cfg, model, specs = load(case, family)
    mesh = pm.build_mesh(device="cpu", **split)
    specs = dict(specs)
    specs["layers"] = pm.pipeline_layer_specs(specs["layers"])
    pm.distribute_model(model, mesh, specs)
    tokens = pm.distribute_batch(torch.from_numpy(np.load(f"{d}/{case}/tokens.npy")), mesh)
    return cfg, model, specs, mesh, tokens


def save_grads(case, model):
    grads = {n: p.grad.full_tensor().numpy() for n, p in model.named_parameters()}
    if rank == 0:
        for n, g in grads.items():
            np.save(f"{d}/{case}/grad_{n}.npy", g)


for case, spec in args["run"].items():
    t0 = time.perf_counter()
    cfg, model, specs, mesh, tokens = placed(case, spec["family"], spec["split"])
    rec = {}
    if spec.get("layout"):
        local = tfm.nest({n: p.to_local() for n, p in model.named_parameters()})
        rec["layout"] = pm.checkpoint_layout(mesh, local, specs).to_meta()
        rec["wq_local"] = list(model.layers["wq"].to_local().shape)
    loss_fn = pl.make_pipelined_loss_fn(cfg, mesh, n_micro=spec["n_micro"], family=spec["family"])
    if spec.get("grads"):
        with tfm.sharding_context(model):
            loss = loss_fn(model, tokens)
            loss.backward()
        save_grads(case, model)
        model.zero_grad(set_to_none=True)
    else:
        with torch.no_grad():
            loss = loss_fn(model, tokens)
    rec["loss"] = float(loss.full_tensor())
    if spec.get("aux_cfg"):
        cfg_aux = moe.MoEConfig.tiny(dtype=torch.float32)
        with torch.no_grad():
            rec["loss_aux"] = float(pl.make_pipelined_loss_fn(
                cfg_aux, mesh, n_micro=spec["n_micro"], family="moe")(model, tokens).full_tensor())
    if spec.get("steps"):
        step, init_opt = pl.make_pipelined_train_step(cfg, mesh, n_micro=spec["n_micro"],
                                                      family=spec["family"])
        opt = init_opt(model)
        rec["losses"] = [float(step(model, opt, tokens)[2]) for _ in range(spec["steps"])]
    rec["seconds"] = time.perf_counter() - t0
    out[case] = rec

if args.get("errors"):
    errs = {}
    def expect(key, fn):
        try:
            fn()
        except ValueError as e:
            errs[key] = str(e)
    cfg3 = tfm.TransformerConfig.tiny(n_layers=3)
    cfg4 = tfm.TransformerConfig.tiny(n_layers=4)
    expect("layers", lambda: pl.make_pipelined_loss_fn(cfg3, pm.build_mesh(device="cpu", dp=2, pp=2), 2))
    expect("sp", lambda: pl.make_pipelined_loss_fn(cfg4, pm.build_mesh(device="cpu", sp=2, pp=2), 2))
    mesh_ok = pm.build_mesh(device="cpu", dp=2, pp=2)
    expect("n_micro", lambda: pl.make_pipelined_loss_fn(cfg4, mesh_ok, n_micro=0))
    fn = pl.make_pipelined_loss_fn(cfg4, mesh_ok, n_micro=4)
    expect("batch", lambda: fn(tfm.init_params(0, cfg4, device="cpu"),
                               torch.zeros((6, 16), dtype=torch.int64)))
    out["errors"] = errs
result(out)
"""


def _save_case(root, case, params, tokens):
    d = root / case
    d.mkdir()
    flat = tfm.flat_names(numpy_tree(params))
    for k, v in flat.items():
        np.save(d / f"{k}.npy", v)
    np.save(d / "tokens.npy", np.asarray(tokens).astype(np.int64))
    return sorted(flat)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """The reference's weights and tokens of each case as files, and its
    unpipelined losses and gradients."""
    root = tmp_path_factory.mktemp("pipeline")
    ref = {}

    dense = ref_tfm.TransformerConfig.tiny(dtype=jnp.float32, n_layers=4)
    params = ref_tfm.init_params(jax.random.PRNGKey(0), dense)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (8, 32), 0, dense.vocab_size)
    loss, grads = jax.value_and_grad(lambda p: ref_tfm.loss_fn(p, tokens, dense))(params)
    ref["dense_f32"] = {"names": _save_case(root, "dense_f32", params, tokens),
                        "cfg": {"n_layers": 4, "dtype": "float32"}, "loss": float(loss),
                        "grads": tfm.flat_names(numpy_tree(grads))}

    bf16 = ref_tfm.TransformerConfig.tiny()
    params = ref_tfm.init_params(jax.random.PRNGKey(0), bf16)
    ref["dense_bf16"] = {"names": _save_case(root, "dense_bf16", params, tokens),
                         "cfg": {"dtype": "bfloat16"},
                         "loss": float(ref_tfm.loss_fn(params, tokens, bf16))}

    params = ref_tfm.init_params(jax.random.PRNGKey(2), dense)
    tokens4 = jax.random.randint(jax.random.PRNGKey(3), (6, 16), 0, dense.vocab_size)
    ref["four_stages"] = {"names": _save_case(root, "four_stages", params, tokens4),
                          "cfg": {"n_layers": 4, "dtype": "float32"},
                          "loss": float(ref_tfm.loss_fn(params, tokens4, dense))}

    moe_cfg = ref_moe.MoEConfig.tiny(dtype=jnp.float32, router_aux_weight=0.0)
    moe_aux = ref_moe.MoEConfig.tiny(dtype=jnp.float32)
    params = ref_moe.init_params(jax.random.PRNGKey(0), moe_cfg)
    ref["moe"] = {"names": _save_case(root, "moe", params, tokens),
                  "cfg": {"dtype": "float32", "router_aux_weight": 0.0},
                  "loss": float(ref_moe.loss_fn(params, tokens, moe_cfg)),
                  "loss_aux": float(ref_moe.loss_fn(params, tokens, moe_aux))}

    hop_tokens = np.random.default_rng(11).integers(0, moe_cfg.vocab_size, (8, 32))
    ref["stage_hop"] = {"names": _save_case(root, "stage_hop", params, hop_tokens),
                        "cfg": {"dtype": "float32"},
                        "loss": float(ref_moe.loss_fn(params, jnp.asarray(hop_tokens, jnp.int32),
                                                      moe_cfg))}
    return root, ref


@pytest.fixture(scope="module")
def worlds(cases):
    root, ref = cases
    files = {k: {"names": v["names"], "cfg": v["cfg"]} for k, v in ref.items()}
    four = run_gloo(CHILD, 4, {"dir": str(root), "cases": files, "errors": True, "run": {
        "dense_f32": {"family": "dense", "split": {"pp": 2, "tp": 2}, "n_micro": 4,
                      "grads": True, "layout": True},
        "four_stages": {"family": "dense", "split": {"pp": 4}, "n_micro": 3},
        "dense_bf16": {"family": "dense", "split": {"pp": 2, "tp": 2}, "n_micro": 2},
        "moe": {"family": "moe", "split": ref_mesh.moe_pipeline_split(4), "n_micro": 4,
                "aux_cfg": True, "steps": 1},
    }}, threads=2)
    two = run_gloo(CHILD, 2, {"dir": str(root), "cases": files, "run": {
        "stage_hop": {"family": "moe", "split": {"pp": 2}, "n_micro": 4, "steps": 3},
    }}, threads=4)
    return four, two


def test_dense_pipeline_exact_in_f32(worlds, cases):
    root, ref = cases
    four, _ = worlds
    want = ref["dense_f32"]
    for run in four:
        assert run["dense_f32"]["loss"] == pytest.approx(want["loss"], abs=1e-5)
    rel = {}
    for name, g_ref in want["grads"].items():
        g = np.load(root / "dense_f32" / f"grad_{name}.npy")
        rel[name] = float(np.abs(g_ref - g).max() / (np.abs(g_ref).max() + 1e-9))
    assert max(rel.values()) < 1e-4, rel


def test_layers_are_local_per_stage_and_the_layout_is_the_references(worlds):
    """Each pp rank holds its L/pp layers (and its tp shard); the checkpoint layout of
    the local tree describes ``[L]`` as sharded over ``pp``, as the reference's does."""
    four, _ = worlds
    cfg = ref_tfm.TransformerConfig.tiny(dtype=jnp.float32, n_layers=4)
    specs = ref_mesh.param_specs(cfg)
    specs["layers"] = ref_mesh.pipeline_layer_specs(specs["layers"])
    mesh = ref_mesh.build_mesh(devices=jax.devices()[:4], pp=2, tp=2)
    sizes = ref_mesh.axis_sizes(mesh)
    shapes = jax.eval_shape(lambda: ref_tfm.init_params(jax.random.PRNGKey(0), cfg))
    local = jax.tree.map(
        lambda s, spec: np.zeros([n // (sizes[a] if a else 1) for n, a in zip(s.shape, spec)],
                                 np.float32),
        shapes, specs, is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    want = ref_mesh.checkpoint_layout(mesh, local, specs).to_meta()
    for run in four:
        assert run["dense_f32"]["wq_local"] == [2, 64, 32]
        assert run["dense_f32"]["layout"] == want


def test_dense_pipeline_four_stages(worlds, cases):
    _, ref = cases
    four, _ = worlds
    for run in four:
        assert run["four_stages"]["loss"] == pytest.approx(ref["four_stages"]["loss"], abs=1e-5)


def test_bf16_pipeline_close(worlds, cases):
    _, ref = cases
    four, _ = worlds
    for run in four:
        assert run["dense_bf16"]["loss"] == pytest.approx(ref["dense_bf16"]["loss"], abs=0.05)


def test_moe_pipeline_with_expert_parallel(worlds, cases):
    """pp = 2 x ep = 2: the aux-free cross-entropy matches the unpipelined MoE (routing is
    per batch row), one train step is finite, and the router aux term, a product of
    per-microbatch means, is compared loosely."""
    _, ref = cases
    four, _ = worlds
    for run in four:
        rec = run["moe"]
        assert rec["loss"] == pytest.approx(ref["moe"]["loss"], abs=1e-4)
        assert np.isfinite(rec["losses"]).all()
        assert rec["loss_aux"] == pytest.approx(ref["moe"]["loss_aux"], abs=0.02)


def test_pipeline_stage_hop_spans_two_processes(worlds, cases):
    """One stage per process: both compute the same losses, training lowers them, and
    the first is within 0.05 of the reference's unpipelined aux-free loss."""
    _, ref = cases
    _, two = worlds
    losses = [run["stage_hop"]["losses"] for run in two]
    assert losses[0] == losses[1]
    assert losses[0][-1] < losses[0][0]
    assert abs(losses[0][0] - ref["stage_hop"]["loss"]) < 0.05, (losses, ref["stage_hop"])


def test_pipeline_rejects_bad_configs(worlds):
    four, _ = worlds
    errs = four[0]["errors"]
    assert "not divisible" in errs["layers"]
    assert "ring attention" in errs["sp"]
    assert "n_micro" in errs["n_micro"]
    assert "divisible by n_micro" in errs["batch"]
    assert all(run["errors"] == errs for run in four)
