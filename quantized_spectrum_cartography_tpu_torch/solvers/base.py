"""Shared solver scaffolding: result container and a functional Adam.

Port of ``quantized_spectrum_cartography_tpu/solvers/base.py``.  Adam is an
explicit per-factor update with optax's defaults (b1 0.9, b2 0.999, eps 1e-8
added outside the square root, no eps_root), so its state is the plain
tensor tuple (count, mu, nu) that a solver snapshot carries, in optax's
layout.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

AdamState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]   # count, mu, nu

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class RecoveryResult:
    """Factors + diagnostics from a recovery run.

    Batched low-rank MLE: S [B, R, I, J]; C [B, R, K]; T_hat [B, K, I, J];
    nmses/costs [B, max_iters].  MLE-GAN (one map): S [R, I, J]; C [R, K];
    T_hat [K, I, J]; nmses/costs [max_iters]."""

    S: torch.Tensor
    C: torch.Tensor
    T_hat: torch.Tensor
    nmses: torch.Tensor
    costs: torch.Tensor
    aux: Optional[Dict[str, Any]] = None


def adam_init(param: torch.Tensor) -> AdamState:
    """optax.adam's initial state: count 0 (int32), zero moments."""
    return (torch.zeros((), dtype=torch.int32, device=param.device),
            torch.zeros_like(param), torch.zeros_like(param))


def value_and_grad(loss_fn: Callable[..., torch.Tensor], *params):
    """(cost, grads) of a loss that returns one cost per map; the maps are
    independent, so the gradient of their sum is each map's own."""
    ps = [p.detach().requires_grad_(True) for p in params]
    with torch.enable_grad():
        cost = loss_fn(*ps)
        grads = torch.autograd.grad(cost.sum(), ps)
    return cost.detach(), grads


def adam_step(lr: float, grad: torch.Tensor, param: torch.Tensor,
              opt_state: AdamState):
    """optax.adam's update and apply_updates, in optax's order of operations."""
    count, mu, nu = opt_state
    mu = (1 - _B1) * grad + _B1 * mu
    nu = (1 - _B2) * grad.square() + _B2 * nu
    count = count + 1
    mu_hat = mu / (1 - torch.pow(_B1, count))
    nu_hat = nu / (1 - torch.pow(_B2, count))
    update = -lr * (mu_hat / (torch.sqrt(nu_hat) + _EPS))
    return param + update, (count, mu, nu)


def adam_update(
    lr: float,
    loss_fn: Callable[[torch.Tensor], torch.Tensor],
    param: torch.Tensor,
    opt_state: AdamState,
):
    """One Adam step on a single factor; returns (param, opt_state, cost)
    with the cost evaluated before the update."""
    cost, (grad,) = value_and_grad(loss_fn, param)
    param, opt_state = adam_step(lr, grad, param, opt_state)
    return param, opt_state, cost


def inner_steps(
    n: int,
    lr: float,
    loss_fn: Callable[[torch.Tensor], torch.Tensor],
    param: torch.Tensor,
    opt_state: AdamState,
    batch_dims: int = 1,
):
    """`n` Adam steps on one factor (the reference's inner loops); returns
    (param, opt_state, last_cost), last_cost 0 when n == 0, one per map of
    the leading `batch_dims` axes of param (0: a single map, a scalar)."""
    cost = None
    for _ in range(n):
        param, opt_state, cost = adam_update(lr, loss_fn, param, opt_state)
    if cost is None:
        cost = torch.zeros(param.shape[:batch_dims], device=param.device)
    return param, opt_state, cost
