"""The port's dense transformer (``tpu_resiliency_torch/models/transformer.py``) held
against the reference (``tpu_resiliency/models/transformer.py``, run in this process on
JAX's CPU) and against ``tests/models/test_transformer.py``'s own checks: the
reference's ``init_params`` weights are carried into the port
(``params_from_reference``), the same seeded tokens go through both, and each
comparison states its tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.torch_model_util import numpy_tree
from tpu_resiliency.models import transformer as ref
from tpu_resiliency_torch.models import transformer as tfm

#: The per-layer leaves of the dense family.
LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down")
#: Logits of the float32 model: the two packages' matmuls sum in other orders.
F32_RTOL, F32_ATOL = 1e-5, 1e-5
#: Logits of the bfloat16 model: a few bf16 ulps of the logit scale (|logit| < 8),
#: the reference's own tolerance for a changed schedule (``tests/models/test_moe.py``).
BF16_ATOL = 0.08
#: One AdamW step on the same gradients, relative to each parameter's scale.
ADAM_RTOL = 1e-6


@pytest.fixture(scope="module")
def weights():
    cfg = ref.TransformerConfig.tiny(dtype=jnp.float32)
    return numpy_tree(ref.init_params(jax.random.PRNGKey(0), cfg))


def tokens_of(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int64)


def port_model(weights, **kw):
    cfg = tfm.TransformerConfig.tiny(**kw)
    return tfm.Transformer(cfg, tfm.params_from_reference(weights, device="cpu"))


def ref_logits(weights, tokens, **kw):
    cfg = ref.TransformerConfig.tiny(**kw)
    return np.asarray(ref.forward(weights, jnp.asarray(tokens, jnp.int32), cfg))


def test_the_weights_carry_across_bit_for_bit(weights):
    model = port_model(weights)
    names = dict(model.named_parameters())
    assert sorted(names) == sorted(["embed", "final_norm", "lm_head"]
                                   + [f"layers.{k}" for k in LAYER_KEYS])
    back = tfm.params_to_reference(model)
    for a, b in zip(jax.tree.leaves(weights), jax.tree.leaves(back)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_float32_logits_match_the_reference(weights):
    tokens = tokens_of(1, (2, 16))
    got = port_model(weights, dtype=torch.float32)(torch.from_numpy(tokens))
    assert got.shape == (2, 16, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), ref_logits(weights, tokens, dtype=jnp.float32),
                               rtol=F32_RTOL, atol=F32_ATOL)


def test_bfloat16_logits_match_the_reference(weights):
    tokens = tokens_of(2, (2, 16))
    got = port_model(weights)(torch.from_numpy(tokens)).detach().numpy()
    want = ref_logits(weights, tokens)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < BF16_ATOL, np.abs(got - want).max()


def test_causality(weights):
    """Changing a future token must not change past logits (reference check), and
    the port's logits follow the reference's on both inputs."""
    model = port_model(weights, dtype=torch.float32)
    t1 = tokens_of(3, (1, 12))
    t2 = t1.copy()
    t2[0, 8] = (t2[0, 8] + 1) % 256
    l1 = model(torch.from_numpy(t1)).detach().numpy()
    l2 = model(torch.from_numpy(t2)).detach().numpy()
    np.testing.assert_array_equal(l1[0, :8], l2[0, :8])
    assert not np.allclose(l1[0, 8:], l2[0, 8:], atol=1e-3)
    for t, got in ((t1, l1), (t2, l2)):
        np.testing.assert_allclose(got, ref_logits(weights, t, dtype=jnp.float32),
                                   rtol=F32_RTOL, atol=F32_ATOL)


def test_token_nll_matches_the_reference():
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    targets = rng.integers(0, 50, (3, 7))
    got = tfm.token_nll(torch.from_numpy(logits), torch.from_numpy(targets)).numpy()
    want = np.asarray(ref.token_nll(jnp.asarray(logits), jnp.asarray(targets, jnp.int32)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_loss_and_gradients_match_the_reference(weights):
    """Gradients relative to each leaf's largest gradient."""
    tokens = tokens_of(5, (4, 32))
    cfg_r = ref.TransformerConfig.tiny(dtype=jnp.float32)
    loss_r, grads_r = jax.value_and_grad(ref.loss_fn)(weights, jnp.asarray(tokens, jnp.int32), cfg_r)
    model = port_model(weights, dtype=torch.float32)
    loss = tfm.loss_fn(model, torch.from_numpy(tokens), model.cfg)
    loss.backward()
    assert abs(float(loss.detach()) - float(loss_r)) <= 1e-6 * abs(float(loss_r))
    grads = tfm.nest({n: p.grad for n, p in model.named_parameters()})
    for (path, g_r), g in zip(jax.tree_util.tree_leaves_with_path(grads_r), jax.tree.leaves(
            tfm.params_to_reference(grads))):
        g_r = np.asarray(g_r)
        assert np.abs(g - g_r).max() <= 1e-4 * np.abs(g_r).max(), path


def test_one_adamw_step_matches_optax(weights):
    """The same gradients through ``optax.adamw(3e-4, weight_decay=0.01)`` and the
    port's default ``torch.optim.AdamW``: one step from fresh state, then one step
    from the reference's state carried across (``adam_state_from_reference``), whose
    state comes back as optax holds it (``adam_state_to_reference``)."""
    rng = np.random.default_rng(6)
    g1, g2 = [jax.tree.map(lambda w: rng.standard_normal(w.shape).astype(np.float32), weights)
              for _ in range(2)]
    opt_r = optax.adamw(3e-4, weight_decay=0.01)
    p1, s1 = _optax_step(opt_r, weights, opt_r.init(weights), g1)
    p2, s2 = _optax_step(opt_r, p1, s1, g2)

    model = port_model(weights, dtype=torch.float32)
    _, init_opt = tfm.make_train_step(model.cfg)
    opt = init_opt(model)
    _torch_step(model, opt, g1)
    _close(tfm.params_to_reference(model), p1)

    model = port_model(p1, dtype=torch.float32)
    opt = init_opt(model)
    adam = s1[0]
    tfm.adam_state_from_reference(model, opt, numpy_tree(adam.mu), numpy_tree(adam.nu),
                                  adam.count)
    _torch_step(model, opt, g2)
    _close(tfm.params_to_reference(model), p2)
    mu, nu, count = tfm.adam_state_to_reference(model, opt)
    assert count == 2 == int(s2[0].count)
    _close(mu, numpy_tree(s2[0].mu))
    _close(nu, numpy_tree(s2[0].nu))


def _optax_step(opt_r, params, state, grads):
    upd, state = opt_r.update(grads, state, params)
    return numpy_tree(optax.apply_updates(params, upd)), state


def _torch_step(model, opt, grads):
    flat = tfm.params_from_reference(grads, device="cpu")
    for name, p in model.named_parameters():
        p.grad = flat[name]
    opt.step()


def _close(got, want):
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=ADAM_RTOL, atol=ADAM_RTOL * np.abs(b).max())


def test_train_step_reduces_loss():
    """The reference's check: ten AdamW steps on a fixed batch cut the loss by 10%."""
    model = tfm.Transformer(tfm.TransformerConfig.tiny(), seed=3, device="cpu")
    train_step, init_opt = tfm.make_train_step(model.cfg)
    opt = init_opt(model)
    tokens = torch.from_numpy(tokens_of(4, (4, 32)))
    losses = []
    for _ in range(10):
        model, opt, loss = train_step(model, opt, tokens)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.9, losses


def test_train_losses_follow_the_reference(weights):
    """Three float32 train steps of both packages from the same weights and batch."""
    tokens = tokens_of(7, (4, 32))
    cfg_r = ref.TransformerConfig.tiny(dtype=jnp.float32)
    step_r, init_r = ref.make_train_step(cfg_r)
    params, state = weights, init_r(weights)
    want = []
    for _ in range(3):
        params, state, loss = jax.jit(step_r)(params, state, jnp.asarray(tokens, jnp.int32))
        want.append(float(loss))
    model = port_model(weights, dtype=torch.float32)
    step, init = tfm.make_train_step(model.cfg)
    opt = init(model)
    got = [float(step(model, opt, torch.from_numpy(tokens))[2]) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_adapt_attn_fn_contract(weights):
    """Custom attn fns get pre-repeated full-head K/V and cannot be combined with
    position_offset; the offset shifts RoPE on the default path (reference check),
    as the reference's offset does."""
    model = port_model(weights, dtype=torch.float32)
    seen = {}

    def spy(q, k, v):
        seen["shapes"] = (q.shape, k.shape, v.shape)
        return tfm._attention(q, k, v)

    tokens = tokens_of(5, (1, 8))
    t = torch.from_numpy(tokens)
    model(t, attn_fn=spy)
    qs, ks, vs = seen["shapes"]
    assert qs[2] == 4 and ks[2] == vs[2] == 4
    with pytest.raises(ValueError, match="position_offset"):
        model(t, attn_fn=spy, position_offset=2)
    base = model(t).detach().numpy()
    off = model(t, position_offset=3).detach().numpy()
    assert not np.allclose(base, off)
    cfg_r = ref.TransformerConfig.tiny(dtype=jnp.float32)
    want = np.asarray(ref.forward(weights, jnp.asarray(tokens, jnp.int32), cfg_r, position_offset=3))
    np.testing.assert_allclose(off, want, rtol=F32_RTOL, atol=F32_ATOL)


def test_llama3_8b_config_and_parameter_count():
    """The reference's config, and the parameter count of its two-layer cut that the
    card's ``model_path`` trains (shapes only: nothing is allocated)."""
    for name in ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads", "d_ff",
                 "max_seq_len", "rope_theta"):
        assert getattr(tfm.TransformerConfig.llama3_8b(), name) == getattr(
            ref.TransformerConfig.llama3_8b(), name)
    cfg = tfm.TransformerConfig.llama3_8b(n_layers=2)
    model = tfm.Transformer(cfg, _meta_tree(cfg))
    cut = dataclasses.replace(ref.TransformerConfig.llama3_8b(), n_layers=2)
    shapes = jax.eval_shape(lambda: ref.init_params(jax.random.PRNGKey(0), cut))
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) == 1_486_901_248
    assert sum(int(np.prod(s.shape[1:])) for s in shapes["layers"].values()) == 218_112_000


def _meta_tree(cfg):
    """The tree's shapes as meta tensors (nothing allocated)."""
    d, h, hkv, dh, f, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                           cfg.d_ff, cfg.n_layers)
    empty = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    return {"embed": empty(cfg.vocab_size, d), "final_norm": empty(d),
            "lm_head": empty(d, cfg.vocab_size),
            "layers": {"attn_norm": empty(L, d), "wq": empty(L, d, h * dh),
                       "wk": empty(L, d, hkv * dh), "wv": empty(L, d, hkv * dh),
                       "wo": empty(L, h * dh, d), "mlp_norm": empty(L, d),
                       "w_gate": empty(L, d, f), "w_up": empty(L, d, f),
                       "w_down": empty(L, f, d)}}


def test_entry_points_default_to_the_card():
    cfg = tfm.TransformerConfig.tiny()
    if torch.cuda.is_available():
        assert tfm.Transformer(cfg).embed.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfm.Transformer(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfm.init_params(0, cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfm.params_from_reference({"embed": np.zeros((2, 2), np.float32)})
    assert tfm.Transformer(cfg, device="cpu").embed.device.type == "cpu"
