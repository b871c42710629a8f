"""Plain reference of batched 1-bit low-rank MLE recovery.

The algorithm of `backup/notebooks/onebit_lowrank.ipynb` cells 1 and 16 as
the JAX package and its port run it: per outer iteration `s_inner` Adam
steps on S with C fixed, then `c_inner` on C, the cost of each map
nll / #observed + l1 ||S||_F + l2 ||C||_F; every `projection_interval`
outer iterations S goes to rank `rank` by randomized subspace iteration
(frozen copy of ``ops/lowrank.py:63-92``, `project_rank_subspace`, with the
probe handed in) and C to the nonnegative orthant.  The projection runs on
the host in the reference's dtype (LAPACK's QR and eigh).

Inputs are the benchmark's own: 1-bit observations, the zero / constant
starts and the projection's probe.  Nothing of the program is imported.
"""

from __future__ import annotations

import torch

from port_bench.reference.numerics import (
    JUDGE,
    OnebitNLL,
    Precision,
    adam_step,
    safe_fro,
    value_and_grad,
)


def project_rank_subspace(S, rank, probe, prec: Precision,
                          power_iters: int = 1):
    m, n = S.shape[-2], S.shape[-1]
    if rank >= min(m, n):
        return S
    St = S.transpose(-1, -2)
    Y = prec.matmul(S, probe)
    for _ in range(power_iters):
        Q, _ = torch.linalg.qr(Y)
        Y = prec.matmul(S, prec.matmul(St, Q))
    Q, _ = torch.linalg.qr(Y)
    Bm = prec.matmul(Q.transpose(-1, -2), S)
    _, evecs = torch.linalg.eigh(prec.matmul(Bm, Bm.transpose(-1, -2)))
    U = prec.matmul(Q, evecs[..., -rank:])
    return prec.matmul(U, prec.matmul(U.transpose(-1, -2), S))


def solve(y01: torch.Tensor, S0: torch.Tensor, C0: torch.Tensor,
          probe: torch.Tensor, solver: dict, mean: float, std: float,
          prec: Precision = JUDGE, max_iters=None):
    """Recover S [B, R, I, J], C [B, R, K] from y01 [B, K, I, J] in {0, 1}
    (every entry observed).  Returns dict(S, C, T_hat, cost) with `cost`
    the last C step's cost of each map, taken before its update, in the
    precision `prec`, on y01's device."""
    B, R, I, J = S0.shape
    K = C0.shape[-1]
    sgn = prec.cast(2.0 * y01.reshape(B, K, I * J) - 1.0)
    count = float(K * I * J)
    l1, l2 = solver["l1"], solver["l2"]

    def cost_fn(S, C):
        nll = OnebitNLL.apply(S.reshape(B, R, -1),
                              C.transpose(1, 2).contiguous(), sgn,
                              mean, std, prec)
        return (nll / count + l1 * safe_fro(S, (-3, -2, -1))
                + l2 * safe_fro(C, (-2, -1)))

    def adam(n, lr, loss, p, st):
        cost = None
        for _ in range(n):
            cost, (g,) = value_and_grad(loss, p)
            p, st = adam_step(lr, g, p, st)
        return p, st, cost

    S, C = prec.cast(S0), prec.cast(C0)
    ss = (0, torch.zeros_like(S), torch.zeros_like(S))
    cs = (0, torch.zeros_like(C), torch.zeros_like(C))
    probe_h = prec.cast(probe).cpu()
    with torch.no_grad():
        for i in range(solver["max_iters"] if max_iters is None
                       else max_iters):
            S, ss, _ = adam(solver["s_inner_iters"], solver["lr_s"],
                            lambda s: cost_fn(s, C), S, ss)
            C, cs, cost = adam(solver["c_inner_iters"], solver["lr_c"],
                               lambda c: cost_fn(S, c), C, cs)
            if (i + 1) % solver["projection_interval"] == 0:
                S = project_rank_subspace(S.cpu(), solver["rank_truncation"],
                                          probe_h, prec).to(S.device)
                C = C.clamp_min(0.0)
    return {"S": S, "C": C, "T_hat": prec.einsum("brij,brk->bkij", S, C),
            "cost": cost}
