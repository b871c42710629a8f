"""Deep-image-prior recovery: optimize untrained decoder weights per map.

Port of ``quantized_spectrum_cartography_tpu/solvers/dip_solver.py``.  The
reference's DIP driver is lost (`qmc/dip.py` is empty); only the
`DecoderDip` architecture survives (deep_prior/networks/dip.py:20-89).
These solvers run the standard DIP protocol on it: fixed random z, Adam on
the decoder's parameters against the observed (masked, possibly 1-bit)
data.  The likelihood is the plain `neg_likelihood_1bit`, as in JAX: DIP
launches no likelihood kernel.

The random draws come from a `torch.Generator`, or as `init=` / `val_mask=`
(how the tests feed in JAX's draws).  Every forward is in train mode
(BatchNorm on the batch's statistics); the running statistics move once a
step, in the forward that takes the gradient, and the forwards that only
read the result (JAX's, whose statistics it discards) leave them as they
are.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from quantized_spectrum_cartography_tpu_torch.models.dip import DecoderDip
from quantized_spectrum_cartography_tpu_torch.models.layers import (
    flax_init_,
    frozen_stats,
)
from quantized_spectrum_cartography_tpu_torch.ops.likelihood import (
    neg_likelihood_1bit,
)
from quantized_spectrum_cartography_tpu_torch.ops.lowrank import (
    get_tensor,
    safe_fro,
)
from quantized_spectrum_cartography_tpu_torch.ops.metrics import nmse
from quantized_spectrum_cartography_tpu_torch.solvers.base import (
    adam_init,
    adam_step,
)


def _decoders(generator, n, z_dim, device) -> List[DecoderDip]:
    """`n` decoders initialized as flax initializes the JAX module."""
    return [flax_init_(DecoderDip(z_dim).to(device), generator)
            for _ in range(n)]


def _cosine_lr(lr: float, count: int, steps: int, alpha: float = 0.1):
    """optax.cosine_decay_schedule(lr, steps, alpha) at update `count`
    (0 for the first update), in float32 as optax computes it."""
    c = torch.tensor(float(min(count, steps)), dtype=torch.float32)
    cosine = 0.5 * (1 + torch.cos(math.pi * c / float(steps)))
    return float(lr * ((1 - alpha) * cosine + alpha))


class _Adam:
    """optax.adam over a list of tensors (one shared step count): `step`
    updates them in place with the gradients at learning rate `lr`."""

    def __init__(self, params: Sequence[torch.Tensor]):
        self.params = list(params)
        self.states = [adam_init(p) for p in self.params]

    @torch.no_grad()
    def step(self, lr: float, grads: Sequence[torch.Tensor]):
        for i, (p, g) in enumerate(zip(self.params, grads)):
            new, self.states[i] = adam_step(lr, g, p, self.states[i])
            p.copy_(new)


def _slfs(decoders, zs) -> torch.Tensor:
    """[R, I, J]: decoder r applied to zs[r] ([1, z])."""
    return torch.stack([dec(z)[0, :, :, 0] for dec, z in zip(decoders, zs)])


def recover_dip(
    generator: Optional[torch.Generator],
    y_obs: torch.Tensor,
    mask: Optional[torch.Tensor],
    mean: float = 0.0,
    std: Optional[float] = None,
    onebit: bool = True,
    steps: int = 1000,
    lr: float = 0.001,
    z_dim: int = 256,
    slf_true: Optional[torch.Tensor] = None,
    init: Optional[Tuple[torch.Tensor, DecoderDip]] = None,
):
    """Recover one SLF [I, J] from observations y_obs (on its device).

    onebit=True: y_obs in {0,1}, probit BCE likelihood (std required);
    onebit=False: masked MSE completion.  `init` = (z [1, z_dim], decoder)
    replaces the draws from `generator` (the decoder is trained in place).
    Returns (S_hat [I, J], losses [steps], nmses [steps])."""
    device = y_obs.device
    if init is None:
        z = torch.randn(1, z_dim, generator=generator, device=device)
        model, = _decoders(generator, 1, z_dim, device)
    else:
        z, model = init
    model.train()
    params = list(model.parameters())
    opt = _Adam(params)

    def loss_fn(S):
        if onebit:
            return neg_likelihood_1bit(
                S[None], y_obs[None], mean, std, probit=True,
                mask=None if mask is None else mask[None])
        m = torch.ones_like(y_obs) if mask is None else mask
        return (m * (S - y_obs).square()).sum() / m.sum().clamp_min(1.0)

    def forward():
        return model(z)[0, :, :, 0]

    losses, nmses = [], []
    for _ in range(steps):
        with torch.enable_grad():
            loss = loss_fn(forward())
            grads = torch.autograd.grad(loss, params)
        opt.step(lr, grads)
        with torch.no_grad(), frozen_stats(model):
            err = (nmse(forward(), slf_true) if slf_true is not None
                   else torch.zeros((), device=device))
        losses.append(loss.detach())
        nmses.append(err)
    with torch.no_grad(), frozen_stats(model):
        S_hat = forward()
    return S_hat, torch.stack(losses), torch.stack(nmses)


def recover_dip_tensor(
    generator: Optional[torch.Generator],
    T_obs: torch.Tensor,
    mean: float,
    std: float,
    num_emitters: int = 2,
    steps: int = 1000,
    lr: float = 0.001,
    z_dim: int = 256,
    T_true: Optional[torch.Tensor] = None,
    holdout_frac: float = 0.05,
    l2_c: float = 0.01,
    val_ema_decay: float = 0.9,
    lr_schedule: str = "constant",
    out_ema_decay: float = 0.0,
    val_mask: Optional[torch.Tensor] = None,
    init: Optional[Tuple[torch.Tensor, Sequence[DecoderDip],
                         torch.Tensor]] = None,
):
    """Full-tensor 1-bit recovery with DIP spatial priors: each emitter's
    SLF is an untrained `DecoderDip` instance (fixed z_r, Adam on its
    weights), C a free nonnegative PSD factor; one Adam (optax's defaults)
    over all the decoders' parameters and C, then C = max(C, 0).

    T_obs [K, I, J] in {0, 1}, on the device the solve runs on.
    `lr_schedule="cosine"` decays lr to lr/10 over the run (optax's
    cosine_decay_schedule, alpha 0.1).

    Early stopping: with `holdout_frac > 0` a random fraction of the entries
    (`val_mask`, drawn from `generator` unless given: JAX's `holdout_key`
    pins it across restarts) is excluded from the fit and scored every
    step; the returned factors are the iterate with the best EMA-smoothed
    validation likelihood (`val_ema_decay`, the EMA started at its first
    value; replaced only on a strict improvement).  `out_ema_decay > 0`
    keeps an EMA of the reconstruction along the trajectory, started at
    the first step's.  `init` = (zs [R, 1, z_dim], R decoders, C0 [R, K])
    replaces the draws (the decoders are trained in place).

    Returns (S_hat [R,I,J], C [R,K], losses, nmses, aux), aux =
    {"holdout_best": smoothed validation NLL at the returned iterate (inf
    when holdout_frac == 0), "final_fit": last training loss, ["T_ema"]}."""
    device = T_obs.device
    R, K = num_emitters, T_obs.shape[0]
    if holdout_frac > 0.0:
        if val_mask is None:
            val_mask = (torch.rand(T_obs.shape, generator=generator,
                                   device=device) < holdout_frac).float()
        train_mask = 1.0 - val_mask
    else:
        val_mask = train_mask = None
    if init is None:
        zs = torch.randn(R, 1, z_dim, generator=generator, device=device)
        decoders = _decoders(generator, R, z_dim, device)
        C = 0.01 * torch.rand(R, K, generator=generator, device=device)
    else:
        zs, decoders, C = init
        C = C.clone()
    nets = torch.nn.ModuleList(decoders).train()
    params = [p for dec in decoders for p in dec.parameters()]
    opt = _Adam(params + [C])

    def loss_fn(S, C):
        return (neg_likelihood_1bit(get_tensor(S, C), T_obs, mean, std,
                                    probit=True, mask=train_mask)
                + l2_c * safe_fro(C))

    def snapshot():
        return ([{k: v.clone() for k, v in dec.state_dict().items()}
                 for dec in decoders], C.clone())

    inf = torch.tensor(float("inf"), device=device)
    ema, best_val = inf, inf
    best = snapshot() if val_mask is not None else None
    t_ema = torch.full_like(T_obs, float("inf"))
    losses, nmses = [], []
    for t in range(steps):
        with torch.enable_grad():
            C.requires_grad_(True)
            loss = loss_fn(_slfs(decoders, zs), C)
            grads = torch.autograd.grad(loss, params + [C])
            C.requires_grad_(False)
        opt.step(_cosine_lr(lr, t, steps) if lr_schedule == "cosine" else lr,
                 grads)
        with torch.no_grad():
            C.clamp_(min=0.0)                         # nonneg projection
            with frozen_stats(nets):
                T_hat = get_tensor(_slfs(decoders, zs), C)
            if out_ema_decay > 0.0:
                t_ema = torch.where(
                    torch.isinf(t_ema[0, 0, 0]), T_hat,
                    out_ema_decay * t_ema + (1.0 - out_ema_decay) * T_hat)
            err = (nmse(T_hat, T_true) if T_true is not None
                   else torch.zeros((), device=device))
            if val_mask is not None:
                val = neg_likelihood_1bit(T_hat, T_obs, mean, std,
                                          probit=True, mask=val_mask)
                ema = torch.where(torch.isinf(ema), val,
                                  val_ema_decay * ema
                                  + (1.0 - val_ema_decay) * val)
                if bool(ema < best_val):
                    best_val, best = ema, snapshot()
        losses.append(loss.detach())
        nmses.append(err)
    holdout_best = inf
    if val_mask is not None:
        holdout_best, (states, C) = best_val, best
        for dec, sd in zip(decoders, states):
            dec.load_state_dict(sd)
    with torch.no_grad(), frozen_stats(nets):
        S_hat = _slfs(decoders, zs)
    losses = torch.stack(losses)
    aux = {"holdout_best": holdout_best, "final_fit": losses[-1]}
    if out_ema_decay > 0.0:
        aux["T_ema"] = t_ema
    return S_hat, C, losses, torch.stack(nmses), aux
