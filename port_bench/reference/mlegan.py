"""Plain reference of MLE-GAN recovery (the reference's `qmc/qmc.ipynb`
cell 1) under a DCGAN generator prior.

The generator: per stage ConvTranspose -> BatchNorm with running
statistics (eps 1e-5) -> ReLU, then a 4x4 convolution and a sigmoid; the
stage table is the configuration's (Generator256: 256 -> 128 -> 64 -> 32 ->
16 -> 2 channels, 1 -> 3 -> 6 -> 12 -> 26 -> 54 -> 51 pixels).  The solver:
per iteration one Adam step on C of nll + lambda_c ||C|| + lambda_s ||Z||,
C clamped at 0; at iteration `z_search_at_iter` the randomized search
(frozen copy of ``solvers/priors.py:36-70``: Z and the global draws scored
by the likelihood, then the best and best + scale * the local draws); one
Adam step on Z of the same cost through the generator, whose cost (taken
before the update) is the iteration's.  The likelihood is the ordinal
probit of log(T + offset) over the observed entries (`BoundsNLL`).

Weights, observations, masks, starts and draws are the benchmark's own.
Nothing of the program is imported.
"""

from __future__ import annotations

import torch

from port_bench.reference.numerics import (
    JUDGE,
    BoundsNLL,
    Precision,
    adam_step,
    safe_fro,
    value_and_grad,
)


def generator_forward(weights: dict, stages, Z, prec: Precision):
    """Z [N, z] -> S [N, 51, 51].  weights: convt.<i>.weight/bias,
    bn.<i>.weight/bias/running_mean/running_var, conv.weight/bias, in
    torch's layouts."""
    def w(name):
        return prec.cast(weights[name])

    x = Z.reshape(Z.shape[0], Z.shape[1], 1, 1)
    for i, (_, _, stride, pad) in enumerate(stages):
        x = prec.conv_transpose2d(x, w(f"convt.{i}.weight"),
                                  w(f"convt.{i}.bias"), stride, pad)
        scale = w(f"bn.{i}.weight") / torch.sqrt(w(f"bn.{i}.running_var")
                                                 + 1e-5)
        shift = w(f"bn.{i}.bias") - w(f"bn.{i}.running_mean") * scale
        x = torch.relu(x * scale[:, None, None] + shift[:, None, None])
    x = prec.conv2d(x, w("conv.weight"), w("conv.bias"), 1, 0)
    return torch.sigmoid(x)[:, 0]


class Problem:
    """One map's observations as the likelihood reads them."""

    def __init__(self, Y, mask, boundaries, quant: dict, prec: Precision):
        bb = torch.as_tensor(boundaries, dtype=prec.dtype, device=Y.device)
        K = Y.shape[0]
        Yf = Y.reshape(1, K, -1).long()
        self.W, self.U = bb[Yf], bb[Yf + 1]
        self.obs = prec.cast(mask.reshape(1, K, -1))
        self.sigma, self.offset = quant["noise_std"], quant["log_offset"]
        self.fast = self.sigma >= 2.0       # the program's `_fast_ok`
        self.prec = prec

    def nll(self, S, C):
        """S [N, R, I, J], C [R, K] -> [N]."""
        N, R = S.shape[:2]
        return BoundsNLL.apply(S.reshape(N, R, -1), C.T[None].contiguous(),
                               self.W, self.U, self.obs, self.sigma,
                               self.offset, self.fast, self.prec)


def search(gen, prob, C, Z0, draws, scale, chunk=512):
    noise_g, noise_l = draws
    R, zd = Z0.shape

    def costs(cand):
        S = torch.cat([gen(c.reshape(-1, zd)) for c in cand.split(chunk)])
        return prob.nll(S.reshape(cand.shape[0], R, *S.shape[1:]), C)

    cand_g = torch.cat([Z0[None], noise_g])
    best_g = cand_g[torch.argmin(costs(cand_g))]
    cand_l = torch.cat([best_g[None], best_g[None] + scale * noise_l])
    return cand_l[torch.argmin(costs(cand_l))]


def solve(Y, mask, weights, stages, Z_init, draws, solver: dict,
          quant: dict, boundaries, prec: Precision = JUDGE,
          max_iters=None):
    """Returns dict(S, C, Z, T_hat, costs [iters]) in `prec`."""
    prob = Problem(Y, mask, boundaries, quant, prec)
    lam_c, lam_s = solver["lambda_c"], solver["lambda_s"]
    R, K = Z_init.shape[0], Y.shape[0]

    def gen(Z):
        return generator_forward(weights, stages, Z, prec)

    def cost(S, C, Z):
        return prob.nll(S[None], C)[0] + lam_c * safe_fro(C) + lam_s * \
            safe_fro(Z)

    Z = prec.cast(Z_init)
    C = torch.zeros(R, K, dtype=prec.dtype, device=Z.device)
    cs = (0, torch.zeros_like(C), torch.zeros_like(C))
    zs = (0, torch.zeros_like(Z), torch.zeros_like(Z))
    iters = solver["max_iters"] if max_iters is None else max_iters
    costs = []
    with torch.no_grad():
        S = gen(Z)
        for i in range(iters):
            _, (g,) = value_and_grad(lambda c: cost(S, c, Z), C)
            C, cs = adam_step(solver["lr_c"], g, C, cs)
            C = C.clamp_min(0.0)
            if i == solver["z_search_at_iter"]:
                Z = search(gen, prob, C, Z, tuple(prec.cast(d) for d in draws),
                           solver["z_search_local_scale"])
            c_z, (g,) = value_and_grad(lambda z: cost(gen(z), C, z), Z)
            Z, zs = adam_step(solver["lr_z"], g, Z, zs)
            S = gen(Z)
            costs.append(c_z)
    return {"S": S, "C": C, "Z": Z, "T_hat": prec.einsum("rij,rk->kij", S, C),
            "costs": torch.stack(costs)}

