"""Why K1's f32 mode may run on the tensor cores in 3xTF32, and not in
single-pass TF32: a numpy emulation of the kernel's sum
(``textgcn_tpu_torch/csrc/bsr_spmm_f32.cu``) on a graph-like block-row.

TF32 is emulated by rounding the low 13 of f32's 23 mantissa bits to the
nearest, ties away from zero (``cvt.rna.tf32.f32``). The kernel splits each
operand v into big = tf32(v) and small = tf32(v - big), sums small_a*big_b,
big_a*small_b and big_a*big_b of each 8-deep k step (one tensor-core
product) into a fresh f32 partial, and adds the partial into its f32
accumulator, k step after k step. The emulation sums a step's products in
f64 and rounds once to f32, then accumulates in f32.

The smoke's limit for the kernel against the plain f32 version is
``F32_TILE_TOL`` = 2e-5 of the largest output (``chip_smoke.py``). Against
the f64 product, 3xTF32 stays within it and near plain f32's error; one
TF32 product misses it by more than 10x."""
import numpy as np
import torch

from textgcn_tpu_torch.ops.bsr_spmm import bsr_spmm_plain

F32_TILE_TOL = 2e-5  # chip_smoke.py's limit, max abs error over max |output|


def tf32(a):
    """Round f32 values to TF32 (10 mantissa bits), to nearest, ties away."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _block_row(n_tiles=16, rows=128, f=64, nnz=225, seed=0):
    """One block-row of a normalized graph: each of 128 rows holds ``nnz``
    edges over ``n_tiles`` * 128 columns, weights 1 / sqrt(d_i d_j) for
    degrees d drawn in [10, 400); features N(0, 1)."""
    rng = np.random.RandomState(seed)
    k = n_tiles * 128
    d_row, d_col = rng.randint(10, 400, rows), rng.randint(10, 400, k)
    a = np.zeros((rows, k), np.float32)
    for i in range(rows):
        cols = rng.choice(k, nnz, replace=False)
        a[i, cols] = 1.0 / np.sqrt(d_row[i] * d_col[cols])
    return a, rng.randn(k, f).astype(np.float32)


def _stepwise(a, x, step_products):
    """sum over k steps of 8: acc = f32(acc + f32(products of the step))."""
    acc = np.zeros((a.shape[0], x.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        d = step_products(a[:, k0 : k0 + 8].astype(np.float64), x[k0 : k0 + 8].astype(np.float64))
        acc = (acc + d.astype(np.float32)).astype(np.float32)
    return acc


def _three(a, b):
    ab, bb = tf32(a), tf32(b)
    as_, bs = tf32(a - ab), tf32(b - bb)
    return as_ @ bb + ab @ bs + ab @ bb


def test_tf32_split_carries_22_bits():
    """big + small equals v within 2^-22 relative, and big alone only within
    2^-11: the split is what carries f32's precision."""
    v = np.random.RandomState(1).randn(10000).astype(np.float32)
    big = tf32(v)
    small = tf32(v - big)
    assert np.all(np.abs(v - big) <= 2.0**-11 * np.abs(v))
    assert np.max(np.abs(v.astype(np.float64) - big - small) / np.abs(v)) <= 2.0**-21
    assert np.array_equal(tf32(big), big) and np.all(big.view(np.uint32) & 0x1FFF == 0)


def test_three_tf32_products_keep_the_f32_tolerance_and_one_does_not():
    a, x = _block_row()
    exact = a.astype(np.float64) @ x.astype(np.float64)
    scale = np.abs(exact).max()
    three = _stepwise(a, x, lambda p, q: _three(p.astype(np.float32), q.astype(np.float32)))
    one = _stepwise(a, x, lambda p, q: tf32(p.astype(np.float32)).astype(np.float64)
                    @ tf32(q.astype(np.float32)).astype(np.float64))
    # the plain f32 version (chip_smoke's reference): one tile, one block-row
    tiles = torch.from_numpy(a.reshape(128, -1, 128).transpose(1, 0, 2).copy())
    plain = bsr_spmm_plain(tiles, torch.tensor([0, tiles.shape[0]], dtype=torch.int32),
                           torch.arange(tiles.shape[0], dtype=torch.int32),
                           torch.from_numpy(x)).numpy()
    err = {name: np.abs(v.astype(np.float64) - exact).max() / scale
           for name, v in (("three", three), ("one", one), ("plain", plain))}
    assert err["three"] <= F32_TILE_TOL / 10
    assert err["three"] <= 4 * err["plain"]
    assert err["one"] > 10 * F32_TILE_TOL
    # and against the plain f32 version, as the smoke holds the kernel
    assert np.abs(three - plain).max() <= F32_TILE_TOL * np.abs(plain).max()
    assert np.abs(one - plain).max() > F32_TILE_TOL * np.abs(plain).max()
