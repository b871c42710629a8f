"""Single-map GAN inversion: latent init and 1-bit recovery of one SLF.

Port of ``quantized_spectrum_cartography_tpu/solvers/gan_inversion.py``:
- `init_z` (`qmc/qmc_utils.py:35-81`): global + local random draws scored
  by MSE to a target SLF, then Adam steps on z;
- `run_onebit_inversion` (`backup/notebooks/one_bit_gan.ipynb` cell 6): the
  same search and descent on a 1-bit loss (BCE, probit, Balevi, Balevi +
  nuclear norm).
The candidates are scored in batched generator passes
(`solvers.priors.randomized_search`); the descent is the port's functional
Adam in optax's order.  The random draws come in through `draws`, or from
`generator` when not given.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from quantized_spectrum_cartography_tpu_torch.ops.likelihood import (
    neg_likelihood_1bit,
)
from quantized_spectrum_cartography_tpu_torch.solvers.base import (
    adam_init,
    adam_update,
)
from quantized_spectrum_cartography_tpu_torch.solvers.priors import (
    randomized_search,
)

# (z0 [1, z_dim], (global [num_global, 1, z_dim], local [num_local, 1, z_dim]))
InversionDraws = Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def _adam_descent(loss_fn: Callable[[torch.Tensor], torch.Tensor],
                  z0: torch.Tensor, lr: float, steps: int):
    """`steps` Adam steps on z from z0; returns (z, losses [..., steps]),
    each loss taken before its step, one per problem of loss_fn's output."""
    z, state, losses = z0, adam_init(z0), []
    for _ in range(steps):
        z, state, cost = adam_update(lr, loss_fn, z, state)
        losses.append(cost)
    return z, (torch.stack(losses, dim=-1) if losses
               else torch.zeros(0, device=z0.device))


def _start(z_dim, device, generator, draws, num_global, num_local):
    if draws is not None:
        return draws
    z0 = torch.randn(1, z_dim, generator=generator, device=device)
    return z0, (torch.randn(num_global, 1, z_dim, generator=generator,
                            device=device),
                torch.randn(num_local, 1, z_dim, generator=generator,
                            device=device))


def init_z(
    gen_apply: Callable[[torch.Tensor], torch.Tensor],
    slf_target: torch.Tensor,
    z_dim: int = 256,
    num_global: int = 200,
    num_local: int = 200,
    adam_steps: int = 100,
    lr: float = 0.01,
    generator: Optional[torch.Generator] = None,
    draws: Optional[InversionDraws] = None,
) -> torch.Tensor:
    """Latent init [1, z_dim] against a known SLF target [I, J]
    (qmc_utils.py:35-81)."""
    z0, search = _start(z_dim, slf_target.device, generator, draws,
                        num_global, num_local)

    def mse(S):                                    # [..., 1, I, J] -> [...]
        return (S[..., 0, :, :] - slf_target).square().mean(dim=(-2, -1))

    z = randomized_search(gen_apply, mse, z0, num_global, num_local,
                          draws=search)
    z, _ = _adam_descent(lambda zz: mse(gen_apply(zz)), z, lr, adam_steps)
    return z


def run_onebit_inversion(
    gen_apply: Callable[[torch.Tensor], torch.Tensor],
    y_quant: torch.Tensor,
    mean: float,
    loss_criterion: str = "bce",
    std: Optional[float] = None,
    z_dim: int = 256,
    num_global: int = 400,
    num_local: int = 200,
    adam_steps: int = 100,
    lr: float = 0.01,
    balevi_lambda: float = 0.5,
    mask: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    draws: Optional[InversionDraws] = None,
):
    """Recover one SLF [I, J] from 1-bit observations y_quant [I, J].

    loss_criterion:
      'bce'        BCE(sigmoid(G(z) - mean), y01), y_quant in {0, 1}
      'probit'     probit-link BCE with noise std
      'balevi'     -lambda * sum(y_pm1 * (G(z) - mean)), y_quant in {-1, +1}
      'balevi-nuc' Balevi correlation + the map's nuclear norm
                   (onebit.ipynb cell 2 `BaleviLoss`)

    Returns (S_hat [I, J], z [1, z_dim], losses [adam_steps]).
    """
    if loss_criterion in ("balevi", "balevi-nuc"):
        nuc = loss_criterion == "balevi-nuc"

        def loss_of_map(S):                        # [..., I, J] -> [...]
            r = S - mean
            if mask is not None:
                r = r * mask
            cost = -balevi_lambda * (y_quant * r).sum(dim=(-2, -1))
            if nuc:
                cost = cost + torch.linalg.svdvals(S).sum(-1)
            return cost
    elif loss_criterion in ("bce", "probit"):
        probit = loss_criterion == "probit"

        m = mask[None] if mask is not None else None

        def loss_of_map(S):                        # one [1, I, J] "map" each
            return neg_likelihood_1bit(S[..., None, :, :], y_quant[None],
                                       mean, std=std, probit=probit, mask=m)
    else:
        raise ValueError(loss_criterion)

    z0, search = _start(z_dim, y_quant.device, generator, draws,
                        num_global, num_local)
    z = randomized_search(gen_apply, lambda S: loss_of_map(S[..., 0, :, :]),
                          z0, num_global, num_local, draws=search)
    z, losses = _adam_descent(lambda zz: loss_of_map(gen_apply(zz)[0]), z,
                              lr, adam_steps)
    with torch.no_grad():
        return gen_apply(z)[0], z, losses
