"""The batched Householder QR (`ops/kernels/householder_qr.py`): the
contract `householder_qr` keeps on every device (Q orthonormal, spanning
Y, on full-rank, rank-deficient and zero Y), its dispatch and input checks,
and the projection that calls it.  The CUDA kernel is held against
`torch.linalg.qr` on the card (tests/test_torch_cuda_kernels.py)."""

import numpy as np
import pytest
import torch

from quantized_spectrum_cartography_tpu_torch.ops import lowrank as lr
from quantized_spectrum_cartography_tpu_torch.ops.kernels import (
    householder_qr as hq,
)

TOL = 1e-5
M, COLS, RANK = 51, 18, 10      # the projection's Y: 51 rows, rank 10 + 8
CASES = ("full", "single", "rank10", "zero", "float64")


def gapped_S(rng, lead, spectrum, right=None):
    """[*lead, M, M] float32 matrices with the given singular values; the
    leading right singular vectors span the columns of `right` if given."""
    n = int(np.prod(lead))
    out = []
    for _ in range(n):
        u, _ = np.linalg.qr(rng.normal(size=(M, M)))
        v = rng.normal(size=(M, M))
        if right is not None:
            v[:, :right.shape[1]] = right
        v, _ = np.linalg.qr(v)
        out.append((u * spectrum) @ v.T)
    return torch.tensor(np.stack(out).reshape(*lead, M, M), dtype=torch.float32)


def make_y(case, rng):
    """Y for one case: full rank [3, 2, 51, 18] or [51, 18]; rank 10 in 18
    columns, from S just after a projection; all zero; float64."""
    if case == "full":
        return torch.tensor(rng.normal(size=(3, 2, M, COLS)),
                            dtype=torch.float32)
    if case == "single":
        return torch.tensor(rng.normal(size=(M, COLS)), dtype=torch.float32)
    if case == "rank10":
        # S's row space holds the probe's first RANK columns, so Y's first
        # RANK columns are well conditioned and fix Q's first RANK columns
        probe = lr.default_probe(M, COLS, device="cpu")
        S = gapped_S(rng, (2, 2), np.r_[np.geomspace(1.0, 0.5, RANK),
                                        np.geomspace(0.1, 1e-3, M - RANK)],
                     right=probe[:, :RANK].double().numpy())
        return lr.project_rank(S, RANK) @ probe
    if case == "zero":
        return torch.zeros(4, M, COLS)
    return torch.tensor(rng.normal(size=(2, 3, M, COLS)), dtype=torch.float64)


@pytest.mark.parametrize("case", CASES)
def test_qr_is_orthonormal(rng, case):
    Q = hq.householder_qr(make_y(case, rng))
    eye = torch.eye(COLS, dtype=Q.dtype)
    assert (Q.transpose(-1, -2) @ Q - eye).abs().max() <= TOL


@pytest.mark.parametrize("case", CASES)
def test_qr_spans_y(rng, case):
    Y = make_y(case, rng)
    Q = hq.householder_qr(Y)
    assert Q.shape == Y.shape and Q.dtype == Y.dtype
    assert (Q @ (Q.transpose(-1, -2) @ Y) - Y).norm() <= TOL * Y.norm()


def test_cpu_tensor_takes_lapack(rng):
    Y = make_y("full", rng)
    before = hq.householder_qr_cuda.launches
    assert torch.equal(hq.householder_qr(Y), torch.linalg.qr(Y)[0])
    assert hq.householder_qr_cuda.launches == before


@pytest.mark.parametrize("bad,exc", [
    (torch.zeros(2, M, COLS, dtype=torch.int32), TypeError),
    (torch.zeros(2, M, COLS, dtype=torch.float16), TypeError),
    (torch.zeros(2, COLS, M), ValueError),            # k > m
    (torch.zeros(0, 2, M, COLS), ValueError),         # empty batch
    (torch.zeros(M), ValueError),                     # not a matrix
    (torch.zeros(2, M, 0), ValueError),               # no columns
])
def test_rejects_what_neither_device_takes(bad, exc):
    with pytest.raises(exc):
        hq.householder_qr(bad)


def test_cuda_wrapper_rejects_cpu_tensor(rng):
    with pytest.raises(ValueError, match="CUDA tensors"):
        hq.householder_qr_cuda(make_y("full", rng))


@pytest.mark.parametrize("spectrum", ["gapped", "rank10"])
def test_projection_at_solver_shape(rng, spectrum):
    """project_rank_subspace at the solver's shape (S [B, R, 51, 51], rank
    10, 8 oversampled columns) on CPU tensors: no kernel launch; S of rank
    10, as right after a projection, is kept as it is, and a gapped S lands
    on the SVD truncation."""
    S = gapped_S(rng, (2, 2), np.r_[np.geomspace(1.0, 0.5, RANK),
                                    np.geomspace(0.05, 1e-4, M - RANK)])
    if spectrum == "rank10":
        S = lr.project_rank(S, RANK)
    before = hq.householder_qr_cuda.launches
    got = lr.project_rank_subspace(S, RANK)
    assert hq.householder_qr_cuda.launches == before
    tol = TOL if spectrum == "rank10" else 1e-3
    assert (got - lr.project_rank(S, RANK)).abs().max() <= tol * S.abs().max()
