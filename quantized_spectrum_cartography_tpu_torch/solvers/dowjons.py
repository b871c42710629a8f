"""DowJons on quantized observations: a Euclidean surrogate on dequantized
bin midpoints.

Port of ``quantized_spectrum_cartography_tpu/solvers/dowjons.py`` (the
reference's `qmc/qmc_dowjons.ipynb` cell 1).  The observations are the bin
midpoints Obs = (W + U) / 2 and the cost is

    || mask * (log(T_hat(S, C) + offset) - Obs) ||^2
      + lambda_c ||C||_F + lambda_s ||Z||_F

with the MLE solver's C/Z alternating Adam and no latent search.  The
surrogate is plain PyTorch under autograd: the JAX package runs no Pallas
kernel on this path either.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from quantized_spectrum_cartography_tpu_torch.config import (
    QuantizerConfig,
    SolverConfig,
)
from quantized_spectrum_cartography_tpu_torch.ops.lowrank import (
    get_tensor,
    project_nonneg,
    safe_fro,
)
from quantized_spectrum_cartography_tpu_torch.ops.metrics import nmse
from quantized_spectrum_cartography_tpu_torch.ops.quantizer import (
    dequantize_midpoints,
)
from quantized_spectrum_cartography_tpu_torch.solvers.base import (
    RecoveryResult,
    adam_init,
    inner_steps,
)


def recover_dowjons(
    Y: torch.Tensor,
    mask: torch.Tensor,
    gen_apply: Callable[[torch.Tensor], torch.Tensor],
    scfg: SolverConfig,
    qcfg: QuantizerConfig,
    Z_init: Optional[torch.Tensor] = None,
    C_init: Optional[torch.Tensor] = None,
    num_emitters: int = 2,
    T_true: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> RecoveryResult:
    """Recover (S = G(Z), C) from bin indices Y [K, I, J] with entry mask
    [K, I, J], on Y's device.  Z_init [R, z] is drawn from `generator`
    unless given; C starts at zero unless C_init [R, K] is given."""
    K = Y.shape[0]
    R = num_emitters
    dev = Y.device
    bb = torch.as_tensor(qcfg.boundaries, dtype=torch.float32, device=dev)
    Obs = dequantize_midpoints(Y, bb)
    offset = qcfg.log_offset
    track_true = T_true is not None

    if Z_init is None:
        Z_init = torch.randn(R, scfg.z_dim, generator=generator, device=dev)
    if C_init is None:
        C_init = torch.zeros(R, K, device=dev)

    def data_cost(S, C):
        T_hat = torch.log(get_tensor(S, C) + offset)
        return (mask * (T_hat - Obs)).square().sum()

    def cost_c(C, S, Z):
        return (data_cost(S, C) + scfg.lambda_c * safe_fro(C)
                + scfg.lambda_s * safe_fro(Z))

    def cost_z(Z, C):
        return (data_cost(gen_apply(Z), C) + scfg.lambda_c * safe_fro(C)
                + scfg.lambda_s * safe_fro(Z))

    with torch.no_grad():
        C, Z = C_init, Z_init
        cs, zs = adam_init(C), adam_init(Z)
        costs, nmses = [], []
        for _ in range(scfg.max_iters):
            S = gen_apply(Z)        # DowJons recomputes S before the C-step
            C, cs, _ = inner_steps(scfg.c_inner_iters, scfg.lr_c,
                                   lambda c: cost_c(c, S, Z), C, cs,
                                   batch_dims=0)
            C = project_nonneg(C)
            Z, zs, cost = inner_steps(scfg.s_inner_iters, scfg.lr_z,
                                      lambda z: cost_z(z, C), Z, zs,
                                      batch_dims=0)
            costs.append(cost)
            nmses.append(nmse(get_tensor(gen_apply(Z), C), T_true)
                         if track_true else torch.zeros((), device=dev))
        S = gen_apply(Z)
    empty = torch.zeros(0, device=dev)
    return RecoveryResult(
        S=S, C=C, T_hat=get_tensor(S, C),
        nmses=torch.stack(nmses) if nmses else empty,
        costs=torch.stack(costs) if costs else empty,
        aux={"Z": Z})
