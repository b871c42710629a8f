"""Block-term (LL1) tensor decomposition baseline.

Port of ``quantized_spectrum_cartography_tpu/baselines/btd.py`` (the
harness's tensorlab `BTD(T, ...)`, `backup/algorithms/joint_opt_ae.m:288`):
T[k,i,j] = sum_r (A_r B_r^T)[i,j] c[k,r] with A_r [I, L], B_r [J, L],
fitted by masked alternating least squares, each update a batched ridge
normal-equation solve.  Leading axes of T are batch axes, and the restarts
run side by side on one more axis; each problem keeps its restart of least
masked residual.

The Gram contractions of three operands go through products of two,
ordered so that no intermediate outgrows [R, R, I*J] per restart:
C's Gram as (S_r * S_p) @ W^T, the row systems of A (and B) as
(W^T (C_r * C_p)) @ (B_r (x) B_p) over the other spatial axis.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from quantized_spectrum_cartography_tpu_torch.solvers.base import gather_winner


def _ridge_solve(G: torch.Tensor, rhs: torch.Tensor, reg: float) -> torch.Tensor:
    """Relative ridge: under sparse masks some rows see few or no observed
    entries, which makes G singular in f32, so G gets reg times its mean
    diagonal (with an absolute floor for all-zero rows).  G [..., n, n],
    rhs [..., n] -> [..., n]."""
    n = G.shape[-1]
    scale = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) / n
    lam = reg * scale.clamp_min(1.0e-12) + 1e-20
    eye = torch.eye(n, dtype=G.dtype, device=G.device)
    return torch.linalg.solve(G + lam[..., None, None] * eye,
                              rhs[..., None])[..., 0]


def _pair_gram(M: torch.Tensor) -> torch.Tensor:
    """(M_r (x) M_p) [..., R, R, N, L*L] of factor blocks M [..., R, N, L]."""
    R, N, L = M.shape[-3:]
    return (M[..., :, None, :, :, None] * M[..., None, :, :, None, :]
            ).reshape(*M.shape[:-3], R, R, N, L * L)


def _row_systems(WkC: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Normal matrices [..., N, R*L, R*L] of the rows of one spatial factor:
    WkC [..., R, R, N, N'] (the masked C-weights, the factor's own axis
    first), M [..., R, N', L] the other factor."""
    R, _, N = WkC.shape[-4:-1]
    L = M.shape[-1]
    G = WkC @ _pair_gram(M)                          # [..., R, R, N, L*L]
    G = G.reshape(*G.shape[:-1], L, L)               # [..., r, p, n, l, m]
    nd = G.ndim
    G = G.permute(*range(nd - 5), nd - 3, nd - 5, nd - 2, nd - 4, nd - 1)
    return G.reshape(*G.shape[:-5], N, R * L, R * L)


def btd_ll1(
    T: torch.Tensor,
    R: int,
    L: int = 5,
    iters: int = 50,
    mask: Optional[torch.Tensor] = None,
    reg: float = 1e-3,
    generator: Optional[torch.Generator] = None,
    restarts: int = 1,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rank-(L,L,1) BTD of T [..., K, I, J]; returns (S [..., R, I, J],
    C [..., R, K], T_hat [..., K, I, J]).

    mask (optional, T's shape, in {0, 1}) selects the observed entries; ALS
    then fits W*T (masked completion, the harness's use at 5-10% sampling).
    ALS depends on its start, so `restarts` starts run on their own axis
    and each problem keeps the lowest masked residual.  `draws` are the
    starts' standard normals (A [..., restarts, R, I, L], B [...,
    restarts, R, J, L], C [..., restarts, R, K]), scaled by 0.1 (C also
    made positive); drawn from `generator` when not given."""
    K, I, J = T.shape[-3:]
    batch = T.shape[:-3]
    if draws is None:
        def normal(*shape):
            return torch.randn(*batch, restarts, R, *shape,
                               generator=generator, device=T.device,
                               dtype=T.dtype)
        draws = (normal(I, L), normal(J, L), normal(K))
    A, Bm, C = (draws[0] * 0.1, draws[1] * 0.1, draws[2].abs() * 0.1)
    W = torch.ones_like(T) if mask is None else mask.to(T.dtype)
    W, T = W[..., None, :, :, :], T[..., None, :, :, :]   # restart axis
    Wf = W.flatten(-2)                                    # [..., 1, K, IJ]
    WTf = (W * T).flatten(-2)
    Wft = Wf.transpose(-1, -2)

    for _ in range(iters):
        # C: per (k) an R x R system on the masked entries
        Sf = (A @ Bm.transpose(-1, -2)).flatten(-2)       # [..., n, R, IJ]
        SS = (Sf[..., :, None, :] * Sf[..., None, :, :]).flatten(-3, -2)
        G = (SS @ Wft).reshape(*SS.shape[:-2], R, R, K)
        rhs = WTf @ Sf.transpose(-1, -2)                  # [..., n, K, R]
        C = _ridge_solve(G.movedim(-1, -3), rhs, reg).transpose(
            -1, -2).clamp_min(0.0)                        # [..., n, R, K]

        # A, then B: per row an (R L) x (R L) system
        CC = (C[..., :, None, :] * C[..., None, :, :]).flatten(-3, -2)
        WkC = (CC @ Wf).reshape(*CC.shape[:-2], R, R, I, J)
        X = (C @ WTf).reshape(*C.shape[:-1], I, J)        # [..., n, R, I, J]
        rhs_i = (X @ Bm).movedim(-3, -2).flatten(-2)      # [..., n, I, R*L]
        A = _ridge_solve(_row_systems(WkC, Bm), rhs_i, reg).reshape(
            *rhs_i.shape[:-1], R, L).movedim(-3, -2)       # [..., n, R, I, L]
        rhs_j = (X.transpose(-1, -2) @ A).movedim(-3, -2).flatten(-2)
        Bm = _ridge_solve(_row_systems(WkC.transpose(-1, -2), A), rhs_j,
                          reg).reshape(*rhs_j.shape[:-1], R, L).movedim(-3, -2)

    S = A @ Bm.transpose(-1, -2)                          # [..., n, R, I, J]
    T_hat = torch.einsum("...rij,...rk->...kij", S, C)
    errs = (W * (T_hat - T).square()).sum(dim=(-3, -2, -1))   # [..., n]
    best = torch.argmin(errs, dim=-1)
    return tuple(gather_winner(x, best) for x in (S, C, T_hat))
