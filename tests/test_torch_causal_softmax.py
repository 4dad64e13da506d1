"""The causal softmax kernel pair (``csrc/causal_softmax.cu``) and the dense attention
that runs it (``models/transformer.py`` ``_attention_fused``).

On the CPU: a numpy model of the kernel's rows, in its order of operations (the
forward's row max ``m``, sum ``l`` and rounded probabilities; the backward's
recomputed probabilities and rounded gradient), held against the plain chain
(``transformer._causal_softmax_plain``) on the same scores, and, standing in for the
kernels inside ``_attention_fused``, against the plain body's output and gradients;
the op's traffic and its refusal of CPU tensors; and the dispatch: CPU, float32 and
DTensor inputs keep the plain body, and a train step counts its calls on its
``model.forward`` span. On the card (``gpu``): the kernels against the plain chain at
a small shape and at the train cell's layer shape, and the launches the wrapper
refuses."""

import math
from fractions import Fraction

import numpy as np
import pytest
import torch

from tests.torch_model_util import run_gloo
from tpu_resiliency_torch.models import transformer as tfm
from tpu_resiliency_torch.ops import causal_softmax as csm
from tpu_resiliency_torch.utils import tracing

MASK = np.float32(-1e30)


# -- the numpy model of the kernel's rows ---------------------------------------------


def bf16_round(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to bfloat16 (nearest, ties to even), as f32."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    bits = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16
    return bits.astype(np.uint32).view(np.float32)


def unmasked(rows: int, tq: int, tk: int, causal_offset: int) -> np.ndarray:
    """Each row's count of unmasked columns, ``clamp(r % tq + causal_offset + 1, 0, tk)``."""
    return np.clip(np.arange(rows) % tq + causal_offset + 1, 0, tk)


def model_forward(s: np.ndarray, tq: int, causal_offset: int, inv: np.float32):
    """``(m, l, p)`` of scores ``s`` ``[rows, tk]`` (bf16 values as f32): the kernel's
    forward. The masked columns hold the row's one constant ``expf(-1e30 - m) / l``."""
    rows, tk = s.shape
    n = unmasked(rows, tq, tk, causal_offset)
    valid = np.arange(tk)[None, :] < n[:, None]
    x = (s * inv).astype(np.float32)
    m = np.where(valid, x, -np.inf).max(axis=1)
    m = np.where(n < tk, np.maximum(m, MASK), m).astype(np.float32)
    e = np.exp(np.where(valid, x - m[:, None], -np.inf).astype(np.float32)).astype(np.float32)
    masked_exp = np.where(n < tk, np.exp((MASK - m).astype(np.float32)), 0).astype(np.float32)
    l = np.where(valid, e, 0).sum(axis=1, dtype=np.float32)
    l = (l + (tk - n).astype(np.float32) * masked_exp).astype(np.float32)
    p = np.where(valid, e / l[:, None], (masked_exp / l)[:, None]).astype(np.float32)
    return m, l, bf16_round(p)


def model_backward(dp: np.ndarray, s: np.ndarray, m, l, tq: int, causal_offset: int,
                   inv: np.float32) -> np.ndarray:
    """The kernel's backward: the probabilities recomputed by the forward's formula,
    ``t = dp * p``, ``c = sum(t)`` over the unmasked columns, ``fma(-p, c, t) * inv``
    rounded (the fused multiply-add taken in float64, one rounding to f32), zeros in
    the masked columns."""
    rows, tk = s.shape
    n = unmasked(rows, tq, tk, causal_offset)
    valid = np.arange(tk)[None, :] < n[:, None]
    x = (s * inv).astype(np.float32)
    e = np.exp(np.where(valid, x - m[:, None], -np.inf).astype(np.float32))
    p = (e / l[:, None]).astype(np.float32)
    t = (dp * p).astype(np.float32)
    c = np.where(valid, t, 0).sum(axis=1, dtype=np.float32)
    ds = (t.astype(np.float64) - p.astype(np.float64) * c[:, None]).astype(np.float32)
    ds = (ds * inv).astype(np.float32)
    return bf16_round(np.where(valid, ds, 0).astype(np.float32))


def f32_round(x: Fraction) -> np.float32:
    """An exact rational rounded to the nearest f32 (ties to even), normal range."""
    if x == 0:
        return np.float32(0)
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    e += (x >= Fraction(2) ** (e + 1)) - (x < Fraction(2) ** e)
    scaled = x * Fraction(2) ** (23 - e)
    mant, rest = divmod(scaled.numerator, scaled.denominator)
    if 2 * rest > scaled.denominator or (2 * rest == scaled.denominator and mant % 2):
        mant += 1
    return np.float32(sign * float(Fraction(mant) * Fraction(2) ** (e - 23)))


def test_the_kernels_division_is_the_correctly_rounded_quotient():
    """``div_by_sum``: ``q = e * r`` with ``r = 1/l`` rounded, then ``q + fma(-q, l, e) *
    r`` rounded (each fma one rounding), equals ``e / l`` rounded for e in [2^-100, 1]
    and a row's sum l in [1, 2^24): over random pairs, and l of all-ones mantissas."""
    rng = np.random.default_rng(7)
    ls = np.concatenate([rng.uniform(1, 4096, 600), rng.integers(1, 1 << 16, 200),
                         [np.nextafter(np.float32(2.0) ** k, 0) for k in range(1, 24)]])
    es = np.concatenate([rng.uniform(0, 1, 400), np.exp(-rng.uniform(0, 69, 400)),
                         [np.nextafter(np.float32(1.0), 0), 2.0 ** -100, 1.0]])
    for l, e in zip(ls.astype(np.float32), rng.permutation(np.resize(es, len(ls))).astype(np.float32)):
        fl, fe = Fraction(float(l)), Fraction(float(e))
        r = f32_round(1 / fl)
        q = f32_round(fe * Fraction(float(r)))
        res = f32_round(fe - Fraction(float(q)) * fl)
        got = f32_round(Fraction(float(q)) + Fraction(float(res)) * Fraction(float(r)))
        assert got == np.float32(e) / np.float32(l), (e, l)


# -- the plain chain, as _attention_plain runs it -------------------------------------


def plain_chain(scores: torch.Tensor, tq: int, causal_offset: int, dh: int) -> torch.Tensor:
    """``_attention_plain``'s chain on scores laid out ``[..., G * Tq, Tk]``."""
    return tfm._causal_softmax_plain(scores.unflatten(-2, (-1, tq)), dh,
                                     causal_offset).flatten(-3, -2)


def masked(rows: int, tq: int, tk: int, causal_offset: int) -> torch.Tensor:
    """``[rows, tk]`` bool, True above the causal diagonal of row ``r`` (query position
    ``r % tq``)."""
    n = torch.from_numpy(unmasked(rows, tq, tk, causal_offset))
    return torch.arange(tk)[None, :] >= n[:, None]


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance in bf16 steps between two bf16 tensors of non-negative values."""
    return (a.view(torch.int16).to(torch.int32) - b.view(torch.int16).to(torch.int32)).abs()


def as_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy().reshape(-1, t.shape[-1])


#: (B, Tq, Tk, H, Hkv, dh, causal_offset): G = 1 and 4, offsets 0 and > 0, Tq != Tk,
#: rows with no unmasked column (a negative offset), odd lengths.
CASES = [
    (2, 24, 24, 4, 4, 16, 0),
    (2, 24, 24, 8, 2, 16, 0),
    (1, 16, 40, 8, 2, 32, 24),
    (2, 13, 13, 4, 1, 8, 0),
    (1, 9, 17, 4, 1, 16, 5),
    (2, 12, 12, 8, 2, 16, -3),
]


def inputs(case, dtype=torch.bfloat16, device="cpu", seed=0):
    b, tq, tk, h, hkv, dh, _ = case
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g).mul(2).to(dtype).to(device).requires_grad_()
               for shape in ((b, tq, h, dh), (b, tk, hkv, dh), (b, tk, hkv, dh)))
    return q, k, v


def layout_scores(q, k):
    """The fused path's bf16 scores ``[B, Hkv, G * Tq, Tk]``."""
    b, tq, h, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, tq, hkv, h // hkv, dh).permute(0, 2, 3, 1, 4).reshape(b, hkv, -1, dh)
    return torch.matmul(qg, k.permute(0, 2, 3, 1))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_the_row_model_holds_against_the_plain_chain(case):
    _, tq, tk, _, _, dh, off = case
    q, k, _ = inputs(case)
    scores = layout_scores(q, k).detach()
    inv = np.float32(csm.inverse_scale(dh))
    m, l, p = model_forward(as_np(scores), tq, off, inv)
    want = plain_chain(scores, tq, off, dh)
    got = torch.from_numpy(p).to(torch.bfloat16).reshape(want.shape)
    ulps = bf16_ulps(got, want)
    assert ulps.max() <= 1 and (ulps == 0).float().mean() >= 0.99, ulps.float().mean()
    rows = unmasked(as_np(scores).shape[0], tq, tk, off)
    # A row with no unmasked column: 1 / Tk everywhere, as the softmax of -1e30s.
    if (rows == 0).any():
        assert np.all(p[rows == 0] == bf16_round(np.float32(1.0 / tk)))
        assert np.all(m[rows == 0] == MASK) and np.all(l[rows == 0] == tk)
    # Every other row is exactly 0 past its prefix.
    past = np.arange(tk)[None, :] >= rows[:, None]
    assert np.all(p[past & (rows[:, None] > 0)] == 0)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_the_backward_model_holds_against_the_plain_chains_gradient(case):
    _, tq, _, _, _, dh, off = case
    q, k, _ = inputs(case)
    scores = layout_scores(q, k).detach().requires_grad_()
    dp = torch.randn(scores.shape, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    (want,) = torch.autograd.grad(plain_chain(scores, tq, off, dh), scores, dp)
    inv = np.float32(csm.inverse_scale(dh))
    s = as_np(scores)
    m, l, _ = model_forward(s, tq, off, inv)
    got = model_backward(as_np(dp), s, m, l, tq, off, inv)
    want = as_np(want)
    # The chain divides by sqrt(dh) on the CPU where the model multiplies by the f32
    # reciprocal, so x may differ by an f32 ulp: a few bf16 steps of the gradient.
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2 ** -6 * scale
    assert np.all(got[want == 0] == 0) or np.abs(got[want == 0]).max() <= 2 ** -7 * scale
    assert np.mean(got == want) >= 0.95


class RowModel(torch.autograd.Function):
    """The numpy row model as an autograd function of CPU scores, in the kernels'
    place."""

    @staticmethod
    def forward(ctx, scores, tq, causal_offset, inv_scale):
        s = as_np(scores)
        m, l, p = model_forward(s, tq, causal_offset, np.float32(inv_scale))
        ctx.geometry = (s, m, l, tq, causal_offset, np.float32(inv_scale), scores.shape)
        return torch.from_numpy(p).to(scores.dtype).reshape(scores.shape)

    @staticmethod
    def backward(ctx, grad_probs):
        s, m, l, tq, causal_offset, inv, shape = ctx.geometry
        ds = model_backward(as_np(grad_probs), s, m, l, tq, causal_offset, inv)
        return torch.from_numpy(ds).to(grad_probs.dtype).reshape(shape), None, None, None


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_the_fused_layout_holds_against_the_plain_body(case, monkeypatch):
    """``_attention_fused``'s products and layouts around the row model's probabilities
    and gradient give the plain body's output and q/k/v gradients."""
    off = case[-1]
    q, k, v = inputs(case)
    want = tfm._attention_plain(q, k, v, off)
    grad = torch.randn(want.shape, generator=torch.Generator().manual_seed(2)).to(want.dtype)
    want_grads = torch.autograd.grad(want, (q, k, v), grad)
    monkeypatch.setattr(csm, "causal_softmax", RowModel.apply)
    got = tfm._attention_fused(q, k, v, off)
    got_grads = torch.autograd.grad(got, (q, k, v), grad)
    for name, a, w in zip(("out", "dq", "dk", "dv"), (got, *got_grads), (want, *want_grads)):
        a, w = a.float(), w.float()
        assert ((a - w).norm() / w.norm()) < 1e-2, name
        assert (a - w).abs().max() <= 2 ** -5 * w.abs().max(), name


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_the_fused_path_on_the_cpu_gives_the_plain_bodys_values(case, dtype, monkeypatch):
    """``_attention_fused`` with the plain chain in the kernels' place, on CPU tensors,
    against ``_attention_plain``: the output and the gradients."""
    dh, off = case[-2], case[-1]
    q, k, v = inputs(case, dtype)
    want = tfm._attention_plain(q, k, v, off)
    monkeypatch.setattr(csm, "causal_softmax",
                        lambda scores, tq, causal_offset, inv: plain_chain(scores, tq,
                                                                            causal_offset, dh))
    got = tfm._attention_fused(q, k, v, off)
    grad = torch.randn(want.shape, generator=torch.Generator().manual_seed(3)).to(dtype)
    tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    for a, w in zip((got, *torch.autograd.grad(got, (q, k, v), grad)),
                    (want, *torch.autograd.grad(want, (q, k, v), grad))):
        a, w = a.float(), w.float()
        assert (a - w).abs().max() <= tol * max(w.abs().max(), 1.0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32], ids=str)
def test_the_op_takes_no_cpu_tensor(dtype):
    csm.reset_launches()
    scores = torch.zeros(2, 8, 8, dtype=dtype)
    with pytest.raises(TypeError if dtype == torch.float32 else ValueError):
        csm.causal_softmax(scores, 8, 0, 1.0)
    assert csm.causal_softmax.launches == 0


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_the_ops_traffic_counts_each_rows_unmasked_prefix(case):
    b, tq, tk, h, _, _, off = case
    rows = b * h * tq
    prefix = int(unmasked(rows, tq, tk, off).sum())
    got = csm.traffic_bytes(rows, tq, tk, off, 2)
    assert got == {"forward": 2 * prefix + 2 * rows * tk + 8 * rows,
                   "backward": 4 * prefix + 8 * rows + 2 * rows * tk}


def test_the_ops_traffic_at_the_train_cells_layer():
    """3 x 32 query heads of 4,096 positions against 4,096 keys in bf16: 4.8 GB
    forward and 6.4 GB backward, 3.36 ms a layer at 3.35 TB/s."""
    got = csm.traffic_bytes(3 * 32 * 4096, 4096, 4096, 0, 2)
    assert round(got["forward"] / 1e9, 2) == 4.84 and round(got["backward"] / 1e9, 2) == 6.45
    assert round((got["forward"] + got["backward"]) / 3.35e12 * 1e3, 2) == 3.37


# -- which body runs -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32], ids=str)
def test_cpu_tensors_keep_the_plain_body(dtype):
    csm.reset_launches()
    before = dict(tfm._attention.calls)
    q, k, v = inputs(CASES[1], dtype)
    out = tfm._attention(q, k, v)
    assert torch.equal(out, tfm._attention_plain(q, k, v))
    assert tfm._attention.calls == {"fused": before["fused"], "plain": before["plain"] + 1}
    assert csm.causal_softmax.launches == 0


def test_the_train_step_counts_its_attention_calls_on_the_forward_span():
    cfg = tfm.TransformerConfig.tiny(n_layers=3)
    model = tfm.Transformer(cfg, seed=0, device="cpu")
    train_step, init_opt = tfm.make_train_step(cfg)
    opt = init_opt(model)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(0))
    tracing.set_capacity()
    tracing.set_step(7)
    try:
        train_step(model, opt, tokens)
        (span,) = [r for r in tracing.spans("model.forward") if r.step == 7]
    finally:
        tracing.set_step(None)
    assert span.counts == {"attention_fused": 0, "attention_plain": 3}


DTENSOR_CHILD = """
from tpu_resiliency_torch.models import transformer as tfm
from tpu_resiliency_torch.ops import causal_softmax as csm
from tpu_resiliency_torch.parallel import mesh as pm

cfg = tfm.TransformerConfig.tiny()
mesh = pm.build_mesh(device="cpu", tp=2)
model = tfm.Transformer(cfg, tfm.init_params(0, cfg, device="cpu"))
pm.distribute_model(model, mesh, pm.param_specs(cfg))
tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(0))
float(tfm.loss_fn(model, pm.distribute_batch(tokens, mesh), cfg))
result({"calls": tfm._attention.calls, "launches": csm.causal_softmax.launches})
"""


def test_dtensor_inputs_keep_the_plain_body_on_their_local_heads():
    for r in run_gloo(DTENSOR_CHILD, 2, threads=2):
        assert r == {"calls": {"fused": 0, "plain": tfm.TransformerConfig.tiny().n_layers},
                     "launches": 0}


# -- on the card ------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def test_the_inverse_scale_is_the_f32_reciprocal():
    assert csm.inverse_scale(64) == 0.125
    assert csm.inverse_scale(128) == float(np.float32(1) / np.float32(math.sqrt(128)))


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [64, 128])
def test_the_card_divides_by_a_python_scalar_as_the_kernel_scales(card, dh):
    s = torch.randn(1 << 20, device=card).to(torch.bfloat16)
    assert torch.equal(s.float() / math.sqrt(dh), s.float() * csm.inverse_scale(dh))


#: The card cases: CASES in bf16 and fp16, and the train cell's layer at B = 1.
CELL_LAYER = (1, 4096, 4096, 32, 8, 128, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("case,dtype", [(c, t) for c in CASES for t in (torch.bfloat16,
                                                                        torch.float16)]
                         + [(CELL_LAYER, torch.bfloat16)],
                         ids=lambda x: "-".join(map(str, x)) if isinstance(x, tuple) else str(x))
def test_on_the_card_the_kernels_give_the_plain_chains_rows(card, case, dtype):
    """The probabilities identical in 99.9% of elements and within one step of the type
    elsewhere; the scores' gradient within the type's rounding of the chain's."""
    _, tq, _, _, _, dh, off = case
    q, k, _ = inputs(case, dtype, card)
    scores = layout_scores(q, k).detach().requires_grad_()
    csm.reset_launches()
    got = csm.causal_softmax(scores, tq, off, csm.inverse_scale(dh))
    want = plain_chain(scores, tq, off, dh)
    ulps = bf16_ulps(got, want)
    assert ulps.max() <= 1 and (ulps == 0).double().mean() >= 0.999, (
        ulps.max(), (ulps == 0).double().mean())
    dp = torch.randn(scores.shape, device=card, dtype=dtype)
    (g_got,) = torch.autograd.grad(got, scores, dp)
    (g_want,) = torch.autograd.grad(want, scores, dp)
    assert csm.causal_softmax.launches_by_pass == {"forward": 1, "backward": 1}
    torch.cuda.synchronize()
    d = (g_got.float() - g_want.float()).abs()
    # Only the rows whose probabilities differ in a rounding step, or whose sums differ
    # in an f32 ulp, differ: by a few steps of the type at the row's largest gradient.
    assert d.max() <= 2 ** -6 * g_want.float().abs().max()
    assert (d == 0).double().mean() >= 0.99
    above = masked(scores.shape[-2], tq, scores.shape[-1], off).to(card)
    assert torch.all(g_got[above.expand_as(g_got)] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES + [CELL_LAYER], ids=lambda c: "-".join(map(str, c)))
def test_on_the_card_the_fused_attention_gives_the_plain_bodys_values(card, case):
    """``_attention`` (the kernel path) against ``_attention_plain`` on the card: the
    output and q/k/v gradients within bf16 rounding (a 2**-7 relative step, at the
    tensor's largest magnitude), and 1% in norm."""
    off = case[-1]
    q, k, v = inputs(case, torch.bfloat16, card)
    before = tfm._attention.calls["fused"]
    got = tfm._attention(q, k, v, off)
    assert tfm._attention.calls["fused"] == before + 1
    want = tfm._attention_plain(q, k, v, off)
    grad = torch.randn(want.shape, device=card, dtype=want.dtype)
    for a, w in zip((got, *torch.autograd.grad(got, (q, k, v), grad)),
                    (want, *torch.autograd.grad(want, (q, k, v), grad))):
        a, w = a.float(), w.float()
        assert (a - w).norm() <= 1e-2 * w.norm()
        assert (a - w).abs().max() <= 2 ** -7 * w.abs().max()


@pytest.mark.gpu
def test_on_the_card_the_wrapper_refuses_what_the_kernel_does_not_take(card):
    s = torch.randn(2, 8, 8, device=card)
    with pytest.raises(TypeError):
        csm.causal_softmax(s, 8, 0, 1.0)  # float32
    with pytest.raises(ValueError):
        csm.causal_softmax(s.to(torch.bfloat16).transpose(-1, -2), 8, 0, 1.0)  # not contiguous
    with pytest.raises(ValueError):
        csm.causal_softmax(s.to(torch.bfloat16), 3, 0, 1.0)  # rows not a multiple of tq
    q, k, v = inputs(CASES[0], torch.float32, card)
    before = dict(tfm._attention.calls)
    tfm._attention(q, k, v)  # float32 compute keeps the plain body
    assert tfm._attention.calls["plain"] == before["plain"] + 1
