"""The port's window reduction (``tpu_resiliency_torch.ops.scoring_kernels``) held
against the JAX package's Pallas ``loop`` kernel, run in interpret mode on the CPU.

Inputs are made from a numpy seed and handed to both. Medians are order statistics
and must be equal bit for bit (+inf included). Weights are f32 sums taken in another
order: each must lie within 1e-5 of its window's sum of absolute values (for all-
positive windows that is rtol 1e-5). Tests marked ``gpu`` hold the CUDA kernel
against the plain version on the card and skip where there is none.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_resiliency.ops.scoring_pallas import fused_median_weights as jax_median_weights
from tpu_resiliency_torch.ops import _build, scoring_kernels as sk

WEIGHT_RTOL = 1e-5


def _windows(seed, r, s, w):
    """Rounded normals (negative values, many ties), duplicate and all-equal windows,
    and counts covering 0, 1, partial and full windows."""
    rng = np.random.default_rng(seed)
    data = np.round(rng.standard_normal((r, s, w)), 1).astype(np.float32)
    data[1] = 3.0
    data[2, 0] = -1.5
    counts = rng.integers(0, w + 1, size=(r, s)).astype(np.int32)
    counts[0, 0] = 0
    counts[0, 1] = 1
    counts[1, 0] = w
    return data, counts


def _assert_weights_close(got, want, data, counts):
    valid = np.arange(data.shape[-1]) < counts[..., None]
    abs_sum = np.where(valid, np.abs(data), 0.0).sum(-1)
    np.testing.assert_array_less(np.abs(got - want), WEIGHT_RTOL * abs_sum + 1e-30)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("w", [1, 5, 16])
def test_plain_version_matches_pallas_loop_kernel(w):
    r, s = 8, 6
    data, counts = _windows(w, r, s, w)
    jm, jw = jax_median_weights(jnp.asarray(data), jnp.asarray(counts), interpret=True, mode="loop")
    tm, tw = sk.fused_median_weights(torch.from_numpy(data), torch.from_numpy(counts))
    assert tm.dtype == torch.float32 and tm.shape == (r, s)
    assert torch.equal(tm, torch.from_numpy(np.array(jm)))
    assert torch.isinf(tm[0, 0])
    _assert_weights_close(tw.numpy(), np.asarray(jw), data, counts)


def test_strided_ring_view_matches_contiguous():
    """MeshTelemetry hands the reduction its [W, R, S] ring permuted to [R, S, W]."""
    data, counts = _windows(3, 8, 5, 12)
    ring = torch.from_numpy(np.ascontiguousarray(data.transpose(2, 0, 1)))
    view = ring.permute(1, 2, 0)
    assert not view.is_contiguous()
    m1, w1 = sk.fused_median_weights(view, torch.from_numpy(counts))
    m2, w2 = sk.fused_median_weights(torch.from_numpy(data), torch.from_numpy(counts))
    assert torch.equal(m1, m2) and torch.equal(w1, w2)


def test_cpu_tensors_take_the_plain_version_without_counting_a_launch():
    data, counts = _windows(4, 4, 3, 8)
    before = sk.fused_median_weights.launches
    got = sk.fused_median_weights(torch.from_numpy(data), torch.from_numpy(counts))
    ref = sk.median_weights_reference(torch.from_numpy(data), torch.from_numpy(counts))
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert sk.fused_median_weights.launches == before


@pytest.mark.parametrize("mode", ["radix", "pairwise"])
def test_unported_modes_raise_naming_the_roadmap(mode):
    data, counts = _windows(5, 4, 2, 4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sk.fused_median_weights(torch.from_numpy(data), torch.from_numpy(counts), mode=mode)


@pytest.mark.parametrize(
    "data,counts,exc",
    [
        (torch.zeros(2, 3, 4), torch.zeros(2, 3, dtype=torch.int32), None),
        (torch.zeros(2, 3, 4, dtype=torch.float64), torch.zeros(2, 3, dtype=torch.int32), TypeError),
        (torch.zeros(2, 3, 4), torch.zeros(2, 3, dtype=torch.int64), TypeError),
        (torch.zeros(2, 3, 4), torch.zeros(3, 2, dtype=torch.int32), ValueError),
        (torch.zeros(2, 3), torch.zeros(2, 3, dtype=torch.int32), ValueError),
    ],
)
def test_wrapper_checks_types_and_shapes(data, counts, exc):
    if exc is None:
        med, wt = sk.fused_median_weights(data, counts)
        assert torch.isinf(med).all() and (wt == 0).all()
    else:
        with pytest.raises(exc):
            sk.fused_median_weights(data, counts)
    with pytest.raises(ValueError, match="unknown mode"):
        sk.fused_median_weights(data, counts, mode="bitonic")


def test_shape_gate_follows_shared_memory():
    assert sk.block_threads(32) == 128
    assert sk.block_threads(sk.MAX_WINDOW) == 32
    for w in (1, 32, 256, sk.MAX_WINDOW):
        assert sk.kernel_supported(w, 64)
        assert sk.block_threads(w) * w * 4 <= sk.MAX_SHARED_BYTES
    assert not sk.kernel_supported(sk.MAX_WINDOW + 1, 64)
    assert not sk.kernel_supported(0, 64)
    assert not sk.kernel_supported(32, 0)


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text(f"#!{sys.executable}\nimport sys\n{body}\n")
    path.chmod(0o755)
    return str(path)


def test_build_records_ptxas_lines_and_seconds(tmp_path, monkeypatch):
    nvcc = _fake_nvcc(tmp_path, (
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'wb').write(b'lib')\n"
        "print(\"ptxas info    : Used 30 registers, 380 bytes cmem[0]\", file=sys.stderr)\n"
        "print('    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads', file=sys.stderr)"
    ))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: nvcc)
    _build.build([sk.KERNEL_NAME])
    _, out, meta = _build._paths(sk.KERNEL_NAME)
    assert out.read_bytes() == b"lib"
    info = json.loads(meta.read_text())
    assert info["build_seconds"] >= 0
    assert any("registers" in line for line in info["ptxas"])
    assert any("spill" in line for line in info["ptxas"])
    assert not [p for p in os.listdir(out.parent) if p.endswith(".tmp")]


def test_failed_build_raises(tmp_path, monkeypatch):
    nvcc = _fake_nvcc(tmp_path, "print('error: bad kernel', file=sys.stderr); sys.exit(2)")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match="bad kernel"):
        _build.build([sk.KERNEL_NAME])
    assert not list((tmp_path / "build").iterdir())


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


@pytest.mark.gpu
@pytest.mark.parametrize("w", [1, 7, 32, 128, 256])
def test_cuda_kernel_matches_plain_version(cuda, w):
    data, counts = _windows(100 + w, 64, 64, w)
    d = torch.from_numpy(data).to(cuda)
    c = torch.from_numpy(counts).to(cuda)
    before = sk.fused_median_weights.launches
    km, kw = sk.fused_median_weights(d, c)
    pm, pw = sk.median_weights_reference(d, c)
    torch.cuda.synchronize()
    assert sk.fused_median_weights.launches == before + 1
    assert torch.equal(km, pm)
    _assert_weights_close(kw.cpu().numpy(), pw.cpu().numpy(), data, counts)


@pytest.mark.gpu
def test_cuda_kernel_reads_the_strided_ring(cuda):
    data, counts = _windows(7, 256, 64, 32)
    ring = torch.from_numpy(np.ascontiguousarray(data.transpose(2, 0, 1))).to(cuda)
    c = torch.from_numpy(counts).to(cuda)
    km, kw = sk.fused_median_weights(ring.permute(1, 2, 0), c)
    pm, pw = sk.median_weights_reference(torch.from_numpy(data).to(cuda), c)
    assert torch.equal(km, pm)
    _assert_weights_close(kw.cpu().numpy(), pw.cpu().numpy(), data, counts)


@pytest.mark.gpu
def test_cuda_kernel_rejects_windows_past_the_gate(cuda):
    w = sk.MAX_WINDOW + 1
    with pytest.raises(ValueError, match="shared-memory limit"):
        sk.fused_median_weights(
            torch.zeros(1, 1, w, device=cuda), torch.zeros(1, 1, dtype=torch.int32, device=cuda)
        )
