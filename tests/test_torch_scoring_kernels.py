"""The port's window reduction (``tpu_resiliency_torch.ops.scoring_kernels``) held
against the JAX package's Pallas ``loop`` kernel, run in interpret mode on the CPU.

Inputs are made from a numpy seed and handed to both. Medians are order statistics
and must be equal bit for bit, compared as int32 (+inf and signed zeros included).
Weights are f32 sums taken in another order: each must lie within 1e-5 of its
window's sum of absolute values (for all-positive windows that is rtol 1e-5). Tests
marked ``gpu`` hold the CUDA kernel against the plain version on the card and skip
where there is none. The ``pairwise`` and ``radix`` modes are held against their JAX
kernels in ``test_torch_scoring_modes.py``.
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


def _bits(t):
    return np.asarray(t, dtype=np.float32).view(np.int32)


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
    tm, tw = sk.fused_median_weights(
        torch.from_numpy(data), torch.from_numpy(counts), mode="loop"
    )
    assert tm.dtype == torch.float32 and tm.shape == (r, s)
    np.testing.assert_array_equal(_bits(tm), _bits(jm))
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


def test_shape_gate_follows_shared_memory(monkeypatch):
    """Each mode's kernel limit is its shared memory; with the loop cap lifted past
    it, the gate of every mode stops exactly there."""
    monkeypatch.setenv(sk.MAX_WINDOW_ENV, str(10 * sk.MAX_WINDOW))
    assert sk.block_threads(32) == 128
    assert sk.block_threads(sk.MAX_WINDOW) == 32
    for w in (1, 32, 256, sk.MAX_WINDOW):
        assert sk.kernel_supported(w, 64, mode="loop")
        assert sk.block_threads(w) * w * 4 <= sk.MAX_SHARED_BYTES
    assert not sk.kernel_supported(sk.MAX_WINDOW + 1, 64, mode="loop")
    staged = 4 * (sk.TILE_WINDOWS + 1) * sk.TILE_MAX_WINDOW + sk.TILE_STATIC_BYTES
    assert staged <= sk.MAX_SHARED_BYTES < staged + 4 * (sk.TILE_WINDOWS + 1)
    for mode in ("pairwise", "radix"):
        assert sk.MODE_MAX_WINDOW[mode] == sk.TILE_MAX_WINDOW
        assert sk.kernel_supported(sk.TILE_MAX_WINDOW, 64, mode=mode)
        assert not sk.kernel_supported(sk.TILE_MAX_WINDOW + 1, 64, mode=mode)
    for mode in (None, *sk.MODES):
        assert not sk.kernel_supported(0, 64, mode=mode)
        assert not sk.kernel_supported(32, 0, mode=mode)


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


def test_build_passes_each_kernels_defines(tmp_path, monkeypatch):
    """The loop kernel's register-network limit and the pairwise kernel's register
    limit reach nvcc from the one place the Python side reads them, and a changed
    value is a different library."""
    nvcc = _fake_nvcc(tmp_path, (
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write(' '.join(a for a in sys.argv if a.startswith('-D')))"
    ))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: nvcc)
    _build.build(sk.KERNEL_NAMES.values())
    _, out, _ = _build._paths(sk.KERNEL_NAME)
    assert out.read_text() == f"-DTR_NETWORK_MAX_WINDOW={sk.NETWORK_MAX_WINDOW}"
    _, other, _ = _build._paths(sk.KERNEL_NAMES["radix"])
    assert other.read_text() == ""
    _, pairwise, _ = _build._paths(sk.KERNEL_NAMES["pairwise"])
    assert pairwise.read_text() == (
        f"-DTR_PAIRWISE_REGISTER_MAX_WINDOW={sk.PAIRWISE_REGISTER_MAX_WINDOW}")
    monkeypatch.setitem(_build.DEFINES, sk.KERNEL_NAME, {"TR_NETWORK_MAX_WINDOW": 32})
    assert _build._paths(sk.KERNEL_NAME)[1] != out


def test_ptxas_lines_are_grouped_by_kernel():
    """``chip_smoke.py`` reads each loop-kernel instance's registers and local memory
    from the build's ptxas lines (the format of ``nvcc -Xptxas -v``)."""
    stderr = "\n".join([
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function '_Z6kernelILi32EEvPf' for 'sm_90a'",
        "ptxas info    : Function properties for _Z6kernelILi32EEvPf",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 56 registers, used 0 barriers, 440 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_Z6kernelILi64EEvPf' for 'sm_90a'",
        "ptxas info    : Function properties for _Z6kernelILi64EEvPf",
        "    24 bytes stack frame, 20 bytes spill stores, 16 bytes spill loads",
        "ptxas info    : Used 255 registers, used 0 barriers, 440 bytes cmem[0]",
    ])
    lines = _build._ptxas_lines(stderr)
    assert not any("gmem" in line or "Function properties" in line for line in lines)
    assert _build.ptxas_by_kernel(lines) == {
        "_Z6kernelILi32EEvPf": {"registers": 56, "stack_frame": 0, "spill_stores": 0,
                                "spill_loads": 0},
        "_Z6kernelILi64EEvPf": {"registers": 255, "stack_frame": 24, "spill_stores": 20,
                                "spill_loads": 16},
    }


def test_register_instances_carry_their_sass_instruction_counts(tmp_path):
    """``chip_smoke.py``'s ``build`` phase reads each register instance's ptxas
    lines and counts its SASS instructions (``cuobjdump -sass`` beside ``nvcc``;
    NOPs left out)."""
    import chip_smoke

    sass = "\n".join([
        "\tcode for sm_90a",
        "\t\tFunction : _Z4regsILi32EEvPf",
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */",
        "                                                              /* 0x000fe20000000f00 */",
        "        /*0010*/              @!P0 FSET.BF.LE.AND R2, R3, R4, PT ;",
        "        /*0020*/                   FADD R5, R5, R2 ;",
        "        /*0030*/                   NOP;",
        "\t\tFunction : _Z5tiledPf",
        "        /*10000*/                   EXIT ;",
    ])
    cuobjdump = tmp_path / "cuobjdump"
    cuobjdump.write_text(f"#!{sys.executable}\nprint({sass!r})\n")
    cuobjdump.chmod(0o755)
    counts = chip_smoke.sass_instructions("lib.so", str(tmp_path / "nvcc"))
    assert counts == {"_Z4regsILi32EEvPf": 3, "_Z5tiledPf": 1}
    ptxas = {"_Z4regsILi32EEvPf": {"registers": 76}, "_Z5tiledPf": {"registers": 31}}
    regs, other = chip_smoke.register_instances(ptxas, r"regsILi(\d+)E", counts)
    assert regs == {32: {"registers": 76, "sass_instructions": 3}}
    assert other == {"registers": 31, "sass_instructions": 1}


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
@pytest.mark.parametrize("w", [1, 2, 7, 31, 32, 33, 63, 64, 65, 128, 256])
def test_cuda_kernel_matches_plain_version(cuda, w):
    """Every size of the register network (W <= 64) and the general path past it."""
    data, counts = _windows(100 + w, 64, 64, w)
    d = torch.from_numpy(data).to(cuda)
    c = torch.from_numpy(counts).to(cuda)
    before = sk.fused_median_weights.launches
    km, kw = sk.fused_median_weights(d, c, mode="loop")
    pm, pw = sk.median_weights_reference(d, c)
    torch.cuda.synchronize()
    assert sk.fused_median_weights.launches == before + 1
    np.testing.assert_array_equal(_bits(km.cpu()), _bits(pm.cpu()))
    _assert_weights_close(kw.cpu().numpy(), pw.cpu().numpy(), data, counts)


@pytest.mark.gpu
@pytest.mark.parametrize("w", [31, 32, 64, 65])
def test_cuda_kernel_reads_the_strided_ring(cuda, w):
    data, counts = _windows(7, 256, 64, w)
    ring = torch.from_numpy(np.ascontiguousarray(data.transpose(2, 0, 1))).to(cuda)
    c = torch.from_numpy(counts).to(cuda)
    km, kw = sk.fused_median_weights(ring.permute(1, 2, 0), c, mode="loop")
    pm, pw = sk.median_weights_reference(torch.from_numpy(data).to(cuda), c)
    np.testing.assert_array_equal(_bits(km.cpu()), _bits(pm.cpu()))
    _assert_weights_close(kw.cpu().numpy(), pw.cpu().numpy(), data, counts)


@pytest.mark.gpu
def test_cuda_kernel_rejects_windows_past_the_gate(cuda):
    for mode in sk.MODES:
        w = sk.MODE_MAX_WINDOW[mode] + 1
        with pytest.raises(ValueError, match="shared-memory limit"):
            sk.fused_median_weights(
                torch.zeros(1, 1, w, device=cuda),
                torch.zeros(1, 1, dtype=torch.int32, device=cuda),
                mode=mode,
            )
