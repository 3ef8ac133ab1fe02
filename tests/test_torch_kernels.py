"""The port's two CUDA kernels and their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed. On a machine with an NVIDIA GPU and nvcc:

    python -m pytest tests/test_torch_kernels.py -q --noconftest

(``--noconftest``: the repo's conftest imports JAX). Tests marked ``cuda``
build the kernels and hold them against the plain versions; they skip where
there is no GPU. The plain versions are held against numpy everywhere.
"""
import numpy as np
import pytest
import torch

from textgcn_tpu_torch.graph import reorder
from textgcn_tpu_torch.graph.normalize import max_symmetrize_coo, sym_normalize_coo
from textgcn_tpu_torch.ops.bsr_spmm import bsr_spmm, bsr_spmm_plain
from textgcn_tpu_torch.ops.row_reduce import row_reduce, row_reduce_plain

CPU = torch.device("cpu")


def _graph(n=700, e=24000, seed=0):
    """A sym-normalized power-law graph with both hybrid legs non-empty."""
    rng = np.random.RandomState(seed)
    p = np.arange(1, n + 1) ** -1.0
    p /= p.sum()
    r, c, v = max_symmetrize_coo(rng.choice(n, e, p=p), rng.choice(n, e, p=p), rng.rand(e), n)
    return (*sym_normalize_coo(r, c, v, n), n)


def _hybrid(dev, f, seed=0):
    r, c, v, n = _graph(seed=seed)
    _, h = reorder.reorder_and_build(r, c, v, n, symmetric=True, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    xp = torch.randn((h.bsr.n_block_rows * 128, f), generator=gen, device=dev)
    return h, xp.to(torch.bfloat16)


def test_bsr_spmm_plain_matches_dense_numpy():
    h, xp = _hybrid(CPU, 24)
    b = h.bsr
    a = np.zeros((b.n_block_rows * 128,) * 2)
    for t in range(b.nnzb):
        i, j = int(b.block_rows[t]) * 128, int(b.block_cols[t]) * 128
        a[i : i + 128, j : j + 128] += b.blocks[t].float().numpy()
    want = a @ xp.float().numpy().astype(np.float64)
    got = bsr_spmm(b.blocks, b.tile_ptr, b.block_cols, xp)  # CPU: plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_base", [True, False])
def test_row_reduce_plain_matches_numpy(with_base):
    h, xp = _hybrid(CPU, 24, seed=1)
    rest = h.rest
    rows = np.repeat(np.arange(rest.row_ptr.numel() - 1), np.diff(rest.row_ptr.numpy()))
    base = torch.randn((xp.shape[0], 24)) if with_base else None
    want = np.zeros((xp.shape[0] if with_base else h.n_nodes, 24))
    if with_base:
        want += base.numpy()
    np.add.at(want, rows, rest.val.numpy()[:, None] * xp.float().numpy()[rest.col.numpy()])
    got = row_reduce(rest.row_ptr, rest.col, rest.val, xp, base=base)
    if with_base:
        assert got is base  # updated in place
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("f", [16, 64, 208])
def test_bsr_spmm_kernel_matches_plain(cuda_dev, f):
    h, xp = _hybrid(cuda_dev, f)
    b = h.bsr
    args = (b.blocks, b.tile_ptr, b.block_cols, xp)
    n0 = bsr_spmm.launches
    got = bsr_spmm(*args)
    torch.cuda.synchronize()
    assert bsr_spmm.launches == n0 + 1
    # the same bf16 products summed in f32 in another order
    torch.testing.assert_close(got, bsr_spmm_plain(*args), rtol=1e-4, atol=1e-4)
    with pytest.raises(TypeError, match="bf16"):
        bsr_spmm(b.blocks.float(), b.tile_ptr, b.block_cols, xp)
    with pytest.raises(ValueError, match="multiple of"):
        bsr_spmm(b.blocks, b.tile_ptr, b.block_cols, xp[:, :8].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("with_base", [True, False])
def test_row_reduce_kernel_matches_plain(cuda_dev, with_base):
    h, xp = _hybrid(cuda_dev, 208, seed=1)
    rest = h.rest
    args = (rest.row_ptr, rest.col, rest.val, xp)
    base = torch.randn(xp.shape, device=cuda_dev) if with_base else None
    n0 = row_reduce.launches
    got = row_reduce(*args, base=None if base is None else base.clone())
    torch.cuda.synchronize()
    assert row_reduce.launches == n0 + 1
    want = row_reduce_plain(*args, base=None if base is None else base.clone())
    # f32 sums of a few products per row (fma vs mul + add)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(TypeError, match="bf16"):
        row_reduce(rest.row_ptr, rest.col, rest.val, xp.float())


@pytest.mark.cuda
def test_hybrid_pass_on_gpu_matches_cpu_plain(cuda_dev):
    r, c, v, n = _graph(seed=6)
    x = torch.from_numpy(np.random.RandomState(0).randn(n, 200).astype(np.float32))
    _, h_cpu = reorder.reorder_and_build(r, c, v, n, symmetric=True, device=CPU)
    _, h_gpu = reorder.reorder_and_build(r, c, v, n, symmetric=True, device=cuda_dev)
    n1, n2 = bsr_spmm.launches, row_reduce.launches
    got = reorder.spmm_hybrid(h_gpu, x.to(cuda_dev)).cpu()
    assert (bsr_spmm.launches, row_reduce.launches) == (n1 + 1, n2 + 1)
    torch.testing.assert_close(got, reorder.spmm_hybrid(h_cpu, x), rtol=1e-4, atol=1e-4)
