"""Systematic Reed-Solomon erasure coding over GF(256), pure numpy.

The byte-economy plane needs exactly one algebraic property: split a shard
into ``k`` data blocks, derive ``m`` parity blocks, and reconstruct the
original from ANY ``k`` of the ``k+m`` coded blocks. A Cauchy-matrix code
gives that property by construction (every square submatrix of a Cauchy
matrix over a field is invertible — the classic result zfec/ISA-L "cauchy"
layouts lean on), and GF(256) keeps every symbol one byte, so encode/decode
are table-lookup + XOR passes that numpy vectorizes to memory speed.

No dependencies beyond numpy: log/antilog tables for the field (primitive
polynomial ``0x11D``), vectorized scalar×vector multiply via the tables,
and a scalar ``k×k`` Gaussian inversion (k is a clique size — single
digits — so the inversion is nanoseconds; the O(k·m) table passes over the
payload are the real cost, and they replace an O(n-1) full-mirror copy of
the same payload on the wire).

Block layout contract: blocks are equal length (``block_len = ceil(total/k)``,
the tail zero-padded); coded index ``i < k`` is data block ``i`` (systematic
— data blocks are verbatim byte ranges of the payload), index ``k+j`` is
parity block ``j``. :func:`split` and :func:`join` own the padding math.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from tpu_resiliency_torch.exceptions import CheckpointError

_PRIM = 0x11D

# log/antilog tables; EXP doubled so EXP[LOG[a] + LOG[b]] never wraps.
_EXP = np.zeros(510, dtype=np.uint8)
_LOG = np.zeros(256, dtype=np.int32)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= _PRIM
_EXP[255:510] = _EXP[:255]


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_EXP[_LOG[a] + _LOG[b]])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("gf_inv(0)")
    return int(_EXP[255 - _LOG[a]])


def _mul_scalar_vec(a: int, v: np.ndarray) -> np.ndarray:
    """``a · v`` over GF(256), vectorized through the log tables."""
    if a == 0:
        return np.zeros_like(v)
    if a == 1:
        return v.copy()
    out = np.zeros_like(v)
    nz = v != 0
    out[nz] = _EXP[_LOG[a] + _LOG[v[nz]]]
    return out


def _addmul_scalar_vec(acc: np.ndarray, a: int, v: np.ndarray) -> None:
    """``acc ^= a · v`` in place (the encode/decode inner loop)."""
    if a == 0:
        return
    if a == 1:
        np.bitwise_xor(acc, v, out=acc)
        return
    nz = v != 0
    acc[nz] ^= _EXP[_LOG[a] + _LOG[v[nz]]].astype(np.uint8)


def parity_matrix(k: int, m: int) -> list[list[int]]:
    """The ``m×k`` parity coefficients.

    ``m == 1`` uses the all-ones row (RAID-5 XOR parity): ``[I; 1]`` has
    every ``k``-row subset invertible (drop one identity row and the ones
    row still spans the missing coordinate), and encode/decode collapse to
    memory-speed XOR passes — the common ``parity=1`` clique pays no GF
    multiply at all. ``m > 1`` uses Cauchy coefficients: row ``j``, column
    ``i`` is ``1/(x_j + y_i)`` with ``x = {0..m-1}``, ``y = {m..m+k-1}``
    (disjoint, so the denominator is never zero); every square submatrix of
    a Cauchy matrix is invertible, so any ``k`` coded blocks reconstruct."""
    if k < 1 or m < 0 or k + m > 256:
        raise CheckpointError(f"rs: unsupported code geometry k={k} m={m}")
    if m == 1:
        return [[1] * k]
    return [[gf_inv(j ^ (m + i)) for i in range(k)] for j in range(m)]


def encode(blocks: Sequence[np.ndarray], m: int) -> list[np.ndarray]:
    """``m`` parity blocks over ``k`` equal-length uint8 data blocks."""
    k = len(blocks)
    mat = parity_matrix(k, m)
    out = []
    for j in range(m):
        acc = np.zeros_like(blocks[0])
        for i, b in enumerate(blocks):
            _addmul_scalar_vec(acc, mat[j][i], b)
        out.append(acc)
    return out


def _invert(mat: list[list[int]]) -> list[list[int]]:
    """Gauss-Jordan inversion of a small GF(256) matrix."""
    k = len(mat)
    a = [row[:] + [1 if i == j else 0 for j in range(k)]
         for i, row in enumerate(mat)]
    for col in range(k):
        piv = next((r for r in range(col, k) if a[r][col]), None)
        if piv is None:
            raise CheckpointError("rs: singular decode matrix")
        a[col], a[piv] = a[piv], a[col]
        inv_p = gf_inv(a[col][col])
        a[col] = [gf_mul(x, inv_p) for x in a[col]]
        for r in range(k):
            if r != col and a[r][col]:
                f = a[r][col]
                a[r] = [x ^ gf_mul(f, y) for x, y in zip(a[r], a[col])]
    return [row[k:] for row in a]


def reconstruct(
    k: int,
    m: int,
    have: Dict[int, np.ndarray],
    want: Optional[Sequence[int]] = None,
) -> Dict[int, np.ndarray]:
    """Recover data blocks from any ``k`` coded blocks.

    ``have`` maps coded index (``0..k+m-1``) → uint8 block; ``want`` lists
    the data indices to recover (default: every missing one). Raises
    :class:`CheckpointError` when fewer than ``k`` blocks survive."""
    if want is None:
        want = [i for i in range(k) if i not in have]
    missing_data = [i for i in want if i not in have]
    if not missing_data:
        return {i: have[i] for i in want}
    if len(have) < k:
        raise CheckpointError(
            f"rs: cannot reconstruct — {len(have)} of {k} required blocks "
            f"survive (have {sorted(have)})"
        )
    # Prefer data blocks (identity rows make the inversion cheaper and the
    # choice deterministic); take the k lowest surviving indices after that.
    chosen = sorted(have, key=lambda i: (i >= k, i))[:k]
    pm = parity_matrix(k, m)
    rows = [
        ([1 if c == i else 0 for c in range(k)] if i < k else pm[i - k])
        for i in chosen
    ]
    inv = _invert(rows)
    out: Dict[int, np.ndarray] = {}
    for t in want:
        if t in have:
            out[t] = have[t]
            continue
        acc = np.zeros_like(have[chosen[0]])
        for r, idx in enumerate(chosen):
            _addmul_scalar_vec(acc, inv[t][r], have[idx])
        out[t] = acc
    return out


class StreamingEncoder:
    """Incremental systematic encode: feed the payload in order, read the
    parity blocks at the end.

    The classic path (:func:`split` + :func:`encode`) pays a payload-sized
    zero-filled backing copy before the first parity byte is computed, plus
    GF table passes whose temporaries are block-sized. This encoder removes
    both: the code is systematic, so data blocks are verbatim byte ranges of
    the payload (the caller can serve them as views — no backing copy), and
    parity accumulates window-by-window as the payload streams past, so the
    transient scratch is O(window), not O(payload). ``update`` is designed to
    ride the same per-leaf pass the save path's ``Checksummer`` already runs.

    Byte-equivalence with the classic path is exact: the tail zero-padding
    :func:`split` materializes is absorbing under GF multiply-accumulate
    (``coeff · 0 = 0``), so never feeding it changes nothing. ``m == 1``
    keeps the RAID-5 property: the all-ones parity row makes every window
    pass a pure in-place XOR with zero allocations.
    """

    def __init__(self, total: int, k: int, m: int, window: int = 1 << 20):
        if total < 0:
            raise CheckpointError(f"rs: negative payload size {total}")
        self.total = int(total)
        self.k = int(k)
        self.m = int(m)
        self.window = max(1, int(window))
        self.block_len = max(1, (self.total + self.k - 1) // self.k)
        self.mat = parity_matrix(self.k, self.m)
        self.parity = [
            np.zeros(self.block_len, dtype=np.uint8) for _ in range(self.m)
        ]
        self._pos = 0

    def update(self, view) -> None:
        """Accumulate one payload part (any bytes-like) into the parity."""
        mv = memoryview(view)
        if mv.ndim != 1 or mv.itemsize != 1:
            mv = mv.cast("B")
        if self._pos + mv.nbytes > self.total:
            raise CheckpointError(
                f"rs: streamed {self._pos + mv.nbytes} bytes past the "
                f"declared total of {self.total}"
            )
        off = 0
        while off < mv.nbytes:
            pos = self._pos + off
            blk = pos // self.block_len
            boff = pos % self.block_len
            n = min(self.window, mv.nbytes - off, self.block_len - boff)
            w = np.frombuffer(mv[off : off + n], dtype=np.uint8)
            for j in range(self.m):
                _addmul_scalar_vec(
                    self.parity[j][boff : boff + n], self.mat[j][blk], w
                )
            off += n
        self._pos += mv.nbytes

    def parity_blocks(self) -> list[np.ndarray]:
        """The ``m`` parity blocks; valid once every declared byte streamed."""
        if self._pos != self.total:
            raise CheckpointError(
                f"rs: parity read after {self._pos} of {self.total} "
                f"declared payload bytes"
            )
        return self.parity


def split(buf, k: int) -> tuple[list[np.ndarray], int]:
    """Cut a byte payload into ``k`` equal blocks (tail zero-padded);
    returns ``(blocks, original_length)``. Blocks are views over one backing
    array, so the padding copy is the only allocation."""
    mv = memoryview(buf)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    total = mv.nbytes
    block_len = max(1, (total + k - 1) // k)
    backing = np.zeros(block_len * k, dtype=np.uint8)
    backing[:total] = np.frombuffer(mv, dtype=np.uint8)
    return [backing[i * block_len : (i + 1) * block_len] for i in range(k)], total


def join(blocks: Sequence[np.ndarray], orig_len: int) -> memoryview:
    """Reassemble :func:`split`'s output (strips the tail padding)."""
    return memoryview(np.concatenate(blocks).data)[:orig_len]
