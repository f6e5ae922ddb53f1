"""Kernel tests that need the GPU: each CUDA kernel of nns_tpu_torch against
its plain PyTorch version on the card, at small shapes that reach every
code path (query tiles past m, many ref splits, several halo tiles, empty
slots, exact ties).

Tolerance: indices exactly equal and min_d2 bit-equal — kernel and plain
version both round each sub, mul and add to nearest in the same order (the
kernels are built with -fmad=false), so there is nothing to tolerate.

They skip without a CUDA device (the decision is made inside the fixture).
This file imports neither jax nor nns_tpu, so it also runs where only the
port is installed: ``python -m pytest tests/test_torch_gpu.py -q
--noconftest``.
"""

import numpy as np
import pytest
import torch

from nns_tpu_torch.data import make_dataset
from nns_tpu_torch.kernels import _cuda
from nns_tpu_torch.kernels.cell_list import CellListEngine, cell_scan, cell_scan_plain
from nns_tpu_torch.kernels.fused import (
    fused_min_idx,
    fused_min_idx_plain,
    fused_splits,
    prepare_refs,
)
from nns_tpu_torch.kernels.oracle import recall_at_1

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100)")
    return torch.device("cuda")


def _assert_same(kernel, plain):
    (kd, ki), (pd, pi) = kernel, plain
    torch.cuda.synchronize()
    assert torch.equal(ki, pi), f"{int((ki != pi).sum())} indices differ"
    assert torch.equal(kd, pd), "min_d2 not bit-equal"


@pytest.mark.parametrize("m,n,k", [(1, 5000, 3), (300, 5000, 3), (17, 70000, 16),
                                   (1000, 3000, 3), (40, 200_000, 3), (33, 777, 5)])
def test_fused_kernel_equals_plain(cuda, m, n, k):
    q, r = make_dataset(k, m, n, seed=100 + m)
    r_dm, _ = prepare_refs(r, 4096, cuda)
    qd = torch.as_tensor(q, device=cuda)
    before = _cuda.LAUNCHES["fused_argmin"]
    got = fused_min_idx(qd, r_dm, n)
    assert _cuda.LAUNCHES["fused_argmin"] == before + 1
    _assert_same(got, fused_min_idx_plain(qd, r_dm, n))
    assert recall_at_1(got[1].cpu().numpy(), q, r) == 1.0


def test_fused_kernel_splits_merge_per_query(cuda):
    # Many ref splits and several query rows whose nearest points sit in
    # different splits: the merge must read each query's own partials.
    rng = np.random.default_rng(5)
    r = rng.random((100_000, 3), dtype=np.float32)
    m = 24
    assert fused_splits(m, r.shape[0], torch.cuda.get_device_properties(cuda).multi_processor_count) > 1
    pick = np.linspace(0, r.shape[0] - 1, m).astype(np.int64)
    q = r[pick] + np.float32(1e-7)
    r_dm, _ = prepare_refs(r, 4096, cuda)
    d, i = fused_min_idx(torch.as_tensor(q, device=cuda), r_dm, r.shape[0])
    np.testing.assert_array_equal(i.cpu().numpy(), pick)


def test_fused_kernel_duplicate_and_equal_refs(cuda):
    rng = np.random.default_rng(6)
    r = rng.random((50_000, 3), dtype=np.float32)
    target = np.array([0.25, 0.5, 0.75], np.float32)
    for w in (11, 25_000, 49_999):
        r[w] = target
    q = np.repeat(target[None], 20, 0)
    r_dm, _ = prepare_refs(r, 4096, cuda)
    got = fused_min_idx(torch.as_tensor(q, device=cuda), r_dm, r.shape[0])
    assert (got[1].cpu().numpy() == 11).all()
    same = np.full((9000, 3), 0.5, np.float32)
    s_dm, _ = prepare_refs(same, 4096, cuda)
    qs = torch.as_tensor(rng.random((7, 3), dtype=np.float32), device=cuda)
    got = fused_min_idx(qs, s_dm, same.shape[0])
    _assert_same(got, fused_min_idx_plain(qs, s_dm, same.shape[0]))
    assert (got[1].cpu().numpy() == 0).all()


@pytest.mark.parametrize("qm,r_max", [(8, 256), (16, 2304), (2048, 1280)])
def test_cell_scan_kernel_equals_plain(cuda, qm, r_max):
    rng = np.random.default_rng(qm + r_max)
    g = 27
    halo = rng.random((g, 3, r_max), dtype=np.float32)
    halo[:, :, r_max - 100:] = 1e6  # sentinel-padded tail
    ids = rng.permutation(g * r_max).astype(np.int32).reshape(g, r_max)
    halo[3, :, 200] = halo[3, :, 7]  # an exact tie inside one group
    dense = rng.random((g, qm, 3), dtype=np.float32)
    dense[:, qm // 2:] = 0.0  # empty slots
    dense[3, 0] = halo[3, :, 7]
    args = (torch.as_tensor(dense, device=cuda), torch.as_tensor(halo, device=cuda),
            torch.as_tensor(ids, device=cuda), float(np.float32(0.05) ** 2))
    before = _cuda.LAUNCHES["cell_scan"]
    got = cell_scan(*args)
    assert _cuda.LAUNCHES["cell_scan"] == before + 1
    _assert_same(got, cell_scan_plain(*args))
    assert int(got[1][3, 0]) == min(ids[3, 7], ids[3, 200])


def test_cell_engine_cuda_equals_cpu(cuda):
    q, r = make_dataset(3, 3000, 65536, seed=7)
    batches = [q[:1000], q[1000:], (q[:400] * np.float32(0.05)).astype(np.float32)]
    gpu = CellListEngine(r, device=cuda)
    cpu = CellListEngine(r, device="cpu")
    for a, b in zip(gpu.query_queue(batches), cpu.query_queue(batches)):
        np.testing.assert_array_equal(a, b)
    idx_g, ok_g, d_g = gpu.query_with_flags_dist(q)
    idx_c, ok_c, d_c = cpu.query_with_flags_dist(q)
    np.testing.assert_array_equal(idx_g, idx_c)
    np.testing.assert_array_equal(ok_g, ok_c)
    np.testing.assert_array_equal(d_g, d_c)
