"""Generator wrapper and randomized latent search for the GAN solvers.

Port of ``quantized_spectrum_cartography_tpu/solvers/priors.py``.  The JAX
package scores candidates one at a time under `lax.map`; here each chunk of
candidates is one batched generator forward, and all candidates of a phase
are scored together by one call of the criterion (one kernel launch in
`recover_mle_gan`).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def make_generator_apply(module: torch.nn.Module,
                         scale: float = 1.0
                         ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Fn Z [N, z_dim] -> S [N, I, J] from a generator module in inference
    mode (frozen batch statistics), divided by `scale` where it is not 1.
    The module's weights are frozen (no gradient), as the solvers use it."""
    module.eval().requires_grad_(False)

    def apply(Z):
        out = module(Z)[..., 0]
        return out / scale if scale != 1.0 else out

    return apply


def randomized_search(
    gen_apply: Callable[[torch.Tensor], torch.Tensor],
    criterion: Callable[[torch.Tensor], torch.Tensor],
    Z0: torch.Tensor,
    num_global: int,
    num_local: int,
    local_scale: float = 0.2,
    chunk: int = 32,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Two-phase randomized latent search; returns the best candidate [R, z].

    Phase 1 scores Z0 and num_global draws Z ~ N(0, I); phase 2 scores the
    best of them and num_local draws best + local_scale * N(0, I).  The
    criterion maps the generator outputs of N candidates [N, R, I, J] to
    their costs [N]; argmin takes the first of equal costs.  `draws` are the
    standard normals ([num_global, R, z], [num_local, R, z]); drawn from
    `generator` when not given."""
    R, zd = Z0.shape

    def normal(n):
        return torch.randn(n, R, zd, generator=generator, device=Z0.device,
                           dtype=Z0.dtype)

    noise_g, noise_l = draws if draws is not None else (
        normal(num_global), normal(num_local))

    def costs(cand):                                  # [N, R, zd] -> [N]
        S = torch.cat([gen_apply(c.reshape(-1, zd))
                       for c in cand.split(chunk)])
        return criterion(S.reshape(cand.shape[0], R, *S.shape[1:]))

    with torch.no_grad():
        cand_g = torch.cat([Z0[None], noise_g.to(Z0)])
        best_g = cand_g[torch.argmin(costs(cand_g))]
        cand_l = torch.cat([best_g[None],
                            best_g[None] + local_scale * noise_l.to(Z0)])
        return cand_l[torch.argmin(costs(cand_l))]
