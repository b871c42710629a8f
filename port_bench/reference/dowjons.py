"""Plain reference of DowJons (`backup/algorithms/joint_opt_ae.m`) under the
z256 VAE decoder, at the base condition of the reference's comparison
harness.

The decoder: a Dense layer latent -> 256, five transposed convolutions
(256 -> 256 -> 128 -> 64 -> 32 -> 4 channels over 1 -> 3 -> 6 -> 12 -> 26 ->
54 px), each followed by BatchNorm from its running statistics (eps 1e-5)
and leaky ReLU 0.2; a k4 convolution 4 -> 16 (54 -> 51), leaky ReLU, two
SAME 3x3 convolutions 16 -> 16 (leaky ReLU) and 16 -> 1; softplus; times
`amp`.  The algorithm:
- SPA (`NMF_SPA.m:1-75`): R bands picked greedily by the squared norm of
  their column-sum-normalized columns with orthogonal deflation, the first
  of equal norms; the picked columns rescaled by the norms of the
  nonnegative pseudo-inverse regression of the map on them (ridge 1e-10);
- the latent start of restart 0 (`:301-317`): `init_steps` Adam steps of
  the scale-free fit of G(z) to the SPA columns on the observed locations
  (the per-emitter gain solved in closed form inside the loss); the other
  restarts start at their handed-in draws;
- per outer iteration, the C-step (`:403-418`): NNLS per band on the
  observed locations by `c_inner_iters` Nesterov-accelerated projected
  gradient steps of length 1 / lambda_max, lambda_max from 30 power
  iterations from the ones vector, the momentum (t - 1) / t_new carried in
  float32; then the S-step (`:444-465`): `s_inner_iters` Adam steps (optax's
  order) on the latents of the masked squared residual through the frozen
  decoder, whose last cost (taken before its step) is the iteration's;
- at the end, the C-step again and the restart of least masked residual.

Departures from `joint_opt_ae.m`: its lsqnonneg is exact, here NNLS runs the
fixed Nesterov iterations the port runs; its latent start comes from the
completion autoencoder's dense completion of the SPA columns and its
estimate is guarded by the Nasdac backstop, both left out here (no
completion model: the configuration's `reduced`); restarts run side by
side and the winner is the least final residual.

Weights, maps, masks and draws are the benchmark's own.  Nothing of the
program is imported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference.numerics import (
    JUDGE,
    Precision,
    adam_step,
    value_and_grad,
)

_MAP = (-3, -2, -1)
SPA_RIDGE = 1e-10
# SPA's tie rule: a band whose squared normalized norm lies within this
# share of the largest could be taken in float32 instead (its rounding is
# about 1e-6); where such a band's column points elsewhere than the largest
# one's by more than DIRECTION_TOL, SPA's start is ill-defined at float32
TIE_TOL = 1e-5
DIRECTION_TOL = 1e-4

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class StraightThrough(Precision):
    """`Precision` whose TF32 rounding passes gradients through unchanged
    (the rounding's bit operations have none), so that a latent descent
    in TF32 descends: what a tensor core's product computes forward."""

    def op(self, x: torch.Tensor) -> torch.Tensor:
        if not self.tf32:
            return x
        return x + (super().op(x.detach()) - x).detach()


CONTROL = StraightThrough(torch.float32, True)


def decoder_forward(weights: dict, prior: dict, Z: torch.Tensor,
                    prec: Precision = JUDGE) -> torch.Tensor:
    """Z [N, latent] -> S [N, 51, 51] at SLF amplitude.  weights in torch's
    layouts: latent_up.weight/bias, convt.<i>.weight/bias,
    bn.<i>.weight/bias/running_mean/running_var, conv.<j>.weight/bias."""
    def w(name):
        return prec.cast(weights[name])

    slope = prior["negative_slope"]
    x = prec.matmul(Z, w("latent_up.weight").T) + w("latent_up.bias")
    x = x.reshape(x.shape[0], x.shape[1], 1, 1)
    for i, (_, _, stride, pad) in enumerate(prior["stages"]):
        x = prec.conv_transpose2d(x, w(f"convt.{i}.weight"),
                                  w(f"convt.{i}.bias"), stride, pad)
        scale = w(f"bn.{i}.weight") / torch.sqrt(w(f"bn.{i}.running_var")
                                                 + 1e-5)
        shift = w(f"bn.{i}.bias") - w(f"bn.{i}.running_mean") * scale
        x = F.leaky_relu(x * scale[:, None, None] + shift[:, None, None],
                         slope)
    last = len(prior["refine"]) - 1
    for j, (_, _, stride, pad) in enumerate(prior["refine"]):
        x = prec.conv2d(x, w(f"conv.{j}.weight"), w(f"conv.{j}.bias"),
                        stride, pad)
        if j < last:
            x = F.leaky_relu(x, slope)
    return F.softplus(x)[:, 0] * prior["amp"]


def gen(weights, prior, Z, prec):
    """The decoder on latents of any leading shape [..., latent]."""
    S = decoder_forward(weights, prior, Z.reshape(-1, Z.shape[-1]), prec)
    return S.reshape(*Z.shape[:-1], *S.shape[-2:])


def get_tensor(S, C, prec):
    return prec.einsum("...rij,...rk->...kij", S, C)


def spa_start(Tm, Tn, colsum, idx, prec: Precision = JUDGE):
    """SPA's start S [..., R, IJ] from the picked bands idx [..., R]: their
    columns Tm [..., IJ, K] (as the normalized columns Tn times their sums
    `colsum` [..., K]), rescaled by the norms of the nonnegative
    pseudo-inverse regression of Tm on them (ridge `SPA_RIDGE`)."""
    IJ = Tn.shape[-2]
    Sm = (torch.gather(Tn, -1, idx[..., None, :].expand(
        *idx.shape[:-1], IJ, idx.shape[-1]))
        * torch.gather(colsum, -1, idx)[..., None, :])       # [..., IJ, R]
    Smt = Sm.transpose(-1, -2)
    eye = torch.eye(idx.shape[-1], dtype=Sm.dtype, device=Sm.device)
    C = torch.linalg.solve(prec.matmul(Smt, Sm) + SPA_RIDGE * eye,
                           prec.matmul(Smt, Tm)).transpose(-1, -2)
    d = torch.linalg.vector_norm(C.clamp_min(0.0), dim=-2)   # [..., R]
    return (Sm * d[..., None, :]).transpose(-1, -2)


def spa(T_km: torch.Tensor, R: int, prec: Precision = JUDGE, follow=None,
        most: int = 32):
    """SPA's start S [B, R, IJ] of T_km [B, K, IJ].

    Bands whose normalized columns point the same way (the bands of one
    emitter alone) tie exactly, and rounding picks among them; they give
    the same start but for the ridge, which weighs a weak band more.  With
    `follow` (the start a program returned, [B, R, IJ]) the start is taken
    at the tied picks (at most `most` a step) that give the start closest
    to it.  Returns (S, tied, followed): `tied` [B] where a band that would
    give another start lies within `TIE_TOL` of the largest norm (SPA's
    start is then ill-defined at float32), `followed` [B] where the start
    was taken at other picks than the first of equal norms."""
    Tm = T_km.transpose(-1, -2)                              # [B, IJ, K]
    s = Tm.sum(dim=-2, keepdim=True)
    Tn = Tm / torch.where(s.abs() > 0, s, torch.ones_like(s))
    colsum = s.squeeze(-2)
    dirs = Tn / torch.linalg.vector_norm(Tn, dim=-2,
                                         keepdim=True).clamp_min(1e-30)
    X, picks, same = Tn, [], []
    tied = torch.zeros(Tm.shape[0], dtype=torch.bool, device=Tm.device)
    for _ in range(R):
        n = X.square().sum(dim=-2)                           # [B, K]
        k = torch.argmax(n, dim=-1)
        near = n >= (1.0 - TIE_TOL) * n.max(dim=-1, keepdim=True).values
        top = torch.gather(dirs, -1, k[:, None, None].expand(
            -1, dirs.shape[1], 1))
        alike = torch.linalg.vector_norm(dirs - top, dim=-2) <= DIRECTION_TOL
        tied |= (near & ~alike).any(dim=-1)
        same.append(near & alike)
        col = torch.gather(X, -1, k[:, None, None].expand(-1, X.shape[1], 1))
        u = col[..., 0] / torch.linalg.vector_norm(
            col[..., 0], dim=-1, keepdim=True).clamp_min(1e-12)
        X = X - u[..., :, None] * (u[..., None, :] @ X)
        picks.append(k)
    idx = torch.stack(picks, dim=-1)                          # [B, R]
    S = spa_start(Tm, Tn, colsum, idx, prec)
    followed = torch.zeros_like(tied)
    if follow is None:
        return S, tied, followed
    out = []
    for b in range(Tm.shape[0]):
        sets = [torch.nonzero(m[b])[:most, 0] for m in same]
        combos = torch.cartesian_prod(*sets).reshape(-1, R)
        M = combos.shape[0]
        cand = spa_start(Tm[b].expand(M, -1, -1), Tn[b].expand(M, -1, -1),
                         colsum[b].expand(M, -1), combos, prec)
        gap = torch.linalg.vector_norm(
            (cand - follow[b].to(cand)).flatten(-2), dim=-1)
        best = int(torch.argmin(gap))
        followed[b] = bool((combos[best] != idx[b]).any())
        out.append(cand[best])
    return torch.stack(out), tied, followed


def momentum(iters: int):
    """The NNLS loop's (t - 1) / t_new, in float32 as the loop carries t."""
    t, out = np.float32(1.0), []
    for _ in range(iters):
        t_new = np.float32(0.5) * (np.float32(1.0) + np.sqrt(
            np.float32(1.0) + np.float32(4.0) * t * t))
        out.append(float((t - np.float32(1.0)) / t_new))
        t = t_new
    return out


def nnls(A, B, iters: int, prec: Precision = JUDGE):
    """argmin_{X >= 0} ||A X - B||_F^2, A [..., M, R], B [..., M, N] ->
    X [..., R, N], by `iters` accelerated projected gradient steps."""
    At = A.transpose(-1, -2)
    AtA, AtB = prec.matmul(At, A), prec.matmul(At, B)
    v = torch.ones(AtA.shape[:-1], dtype=AtA.dtype, device=AtA.device)
    for _ in range(30):
        v = prec.matmul(AtA, v[..., None])[..., 0]
        v = v / torch.linalg.vector_norm(v, dim=-1,
                                         keepdim=True).clamp_min(1e-12)
    L = prec.matmul(v[..., None, :], prec.matmul(AtA, v[..., None]))[
        ..., 0, 0].clamp_min(1e-12)
    step = (1.0 / L)[..., None, None]
    X = Y = torch.zeros_like(AtB)
    for beta in momentum(iters):
        X_new = (Y - step * (prec.matmul(AtA, Y) - AtB)).clamp_min(0.0)
        Y = X_new + beta * (X_new - X)
        X = X_new
    return X


class Problem:
    """B problems' masked observations and the decoder, in `prec`: T_obs
    [B, K, I, J] (zeros off the mask), Om [B, I, J]."""

    def __init__(self, T_obs, Om, weights, prior, solver: dict,
                 prec: Precision = JUDGE):
        self.T_obs = prec.cast(T_obs)
        self.W = prec.cast(Om)[:, None, :, :]                 # [B, 1, I, J]
        self.weights, self.prior, self.solver = weights, prior, solver
        self.prec = prec

    def G(self, z):
        return gen(self.weights, self.prior, self.prec.cast(z), self.prec)

    def c_step(self, S):
        """NNLS per band on the observed locations: S [B, n, R, I, J] ->
        C [B, n, R, K] (or without the restarts' axis)."""
        lead = S.ndim - 4
        W = self.W.reshape(self.W.shape[0], *(1,) * lead, -1)
        design = (S.flatten(-2) * W[..., None, :]).transpose(-1, -2)
        T_flat = (self.T_obs * self.W).flatten(-2)             # [B, K, IJ]
        T_flat = T_flat.reshape(T_flat.shape[0], *(1,) * lead,
                                *T_flat.shape[1:])
        return nnls(design, T_flat.transpose(-1, -2),
                    self.solver["c_inner_iters"], self.prec)

    def z_loss(self, z, C):
        """The masked squared residual of latents z [B, n, R, z] -> [B, n]."""
        T_hat = get_tensor(self.G(z), C, self.prec)
        return (self.W[:, None] * (T_hat - self.T_obs[:, None]).square()
                ).sum(_MAP)

    def spa(self, R: int, follow=None):
        """`spa` of the masked map for R emitters: S_init [B, R, I, J],
        tied, followed."""
        B, _, I, J = self.T_obs.shape
        S, tied, followed = spa(
            (self.T_obs * self.W).flatten(-2), R, self.prec,
            None if follow is None else self.prec.cast(follow).flatten(-2))
        return S.reshape(B, R, I, J), tied, followed


def init_fit(prob: Problem, S_init, z0, steps: int):
    """`steps` Adam steps from z0 [B, R, z] of the scale-free fit of G(z)
    to S_init on the observed locations; (z, costs [B, steps])."""
    fit = prob.W.expand_as(S_init)
    S_init, z = prob.prec.cast(S_init), prob.prec.cast(z0)

    def loss(zz):                                            # -> [B]
        Gm = prob.G(zz)
        a = ((fit * Gm * S_init).sum((-2, -1), keepdim=True)
             / (fit * Gm * Gm).sum((-2, -1), keepdim=True).clamp_min(1e-12))
        return (fit * (a * Gm - S_init).square()).sum(_MAP)

    state, costs = (0, torch.zeros_like(z), torch.zeros_like(z)), []
    for _ in range(steps):
        cost, (g,) = value_and_grad(loss, z)
        z, state = adam_step(prob.solver["lr_z"], g, z, state)
        costs.append(cost)
    return z, (torch.stack(costs, -1) if costs
               else z.new_zeros(z.shape[0], 0))


def outer(prob: Problem, Z, iters: int):
    """`iters` outer iterations (a C-step, then `s_inner_iters` Adam steps on
    the latents) from the restarts' starts Z [B, n, R, z]; returns Z, costs
    [B, n, iters] (each iteration's last, taken before its step), and the
    final S, C and residual [B, n]."""
    Z, sv = prob.prec.cast(Z), prob.solver
    state, costs = (0, torch.zeros_like(Z), torch.zeros_like(Z)), []
    with torch.no_grad():
        for _ in range(iters):
            C = prob.c_step(prob.G(Z))
            for _ in range(sv["s_inner_iters"]):
                cost, (g,) = value_and_grad(lambda zz: prob.z_loss(zz, C), Z)
                Z, state = adam_step(sv["lr_z"], g, Z, state)
            costs.append(cost)
        S = prob.G(Z)
        C = prob.c_step(S)
        final = prob.z_loss(Z, C)
    return Z, torch.stack(costs, -1), S, C, final


def solve(T_obs, Om, weights, prior, draws, solver: dict,
          prec: Precision = JUDGE):
    """The whole of DowJons on B problems from the draws (the init fit's
    start [B, R, z], the restarts' starts [B, n, R, z]), as the program
    answers: the winner's T_hat, S, C, Z and costs [B, max_iters], SPA's
    start, the init fit's costs, the restarts' starts, their final
    residuals [B, n] and `best` [B]."""
    prob = Problem(T_obs, Om, weights, prior, solver, prec)
    S_init, _, _ = prob.spa(draws[0].shape[-2])
    z, init_costs = init_fit(prob, S_init, draws[0], solver["init_steps"])
    Z0 = torch.cat([z[:, None], prec.cast(draws[1])[:, 1:]], dim=1)
    Z, costs, S, C, final = outer(prob, Z0, solver["max_iters"])
    best = torch.argmin(final, -1)

    def pick(x):
        idx = best.reshape(-1, *(1,) * (x.ndim - 1)).expand(
            -1, 1, *x.shape[2:])
        return torch.gather(x, 1, idx)[:, 0]

    S, C = pick(S), pick(C)
    return {"T_hat": get_tensor(S, C, prec), "S": S, "C": C,
            "S_init": S_init, "costs": pick(costs), "Z": pick(Z),
            "best": best, "residuals": final, "init_costs": init_costs,
            "Z_start": Z0}
