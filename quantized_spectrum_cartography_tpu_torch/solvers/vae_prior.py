"""VAE-decoder deep prior: construction, encoder init, checkpoint glue.

Port of ``quantized_spectrum_cartography_tpu/solvers/vae_prior.py``.  The
VAE decoder serves as G: Z [N, latent] -> S [N, I, J] at SLF amplitude, and
its encoder gives an amortized latent init from the observations.  Weights
come from the JAX package's checkpoints, read by
``training.checkpoints.load_checkpoint``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from quantized_spectrum_cartography_tpu_torch.models import VAE
from quantized_spectrum_cartography_tpu_torch.models.ae import HEADS
from quantized_spectrum_cartography_tpu_torch.training.checkpoints import (
    load_checkpoint,
    state_dict_from_flax,
)

DEFAULT_AMP = 0.26   # mean SLF peak of simulator maps; the VAE trains on
                     # peak-normalized targets

# decoder head as checkpoints store it: an index into the decoder's heads
HEAD_CODES = HEADS


def _vae(variables: Dict[str, Any], device, **kw) -> VAE:
    """A VAE in inference mode with the flax tree's weights, frozen."""
    vae = VAE(**kw)
    vae.load_state_dict(state_dict_from_flax(variables))
    return vae.to(device).eval().requires_grad_(False)


def make_vae_generator(
    variables: Dict[str, Any],
    latent_dim: int = 64,
    beta: float = 0.5,
    amp: float = DEFAULT_AMP,
    head: str = "sigmoid",
    dec_width: int = 16,
    refine_width: int = 0,
    device: Optional[str] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Decoder as G: Z [N, latent] -> SLFs [N, I, J] at SLF amplitude."""
    vae = _vae(variables, device, latent_dim=latent_dim, beta=beta, head=head,
               dec_width=dec_width, refine_width=refine_width)

    def gen(Z):
        return vae.decode(Z)[:, 0] * amp

    return gen


def encoder_init(
    variables: Dict[str, Any],
    mask: torch.Tensor,
    observed: torch.Tensor,
    latent_dim: int = 64,
    beta: float = 0.5,
    amp: float = DEFAULT_AMP,
) -> torch.Tensor:
    """Amortized latent init: the encoder's mean of (mask, masked map / amp)
    as channels [mask, map], the training batches' convention.  observed
    may be [I, J] or [R, I, J]; returns z [1 or R, latent], on observed's
    device."""
    vae = _vae(variables, observed.device, latent_dim=latent_dim, beta=beta)
    obs = observed if observed.ndim == 3 else observed[None]
    m = torch.broadcast_to(mask, obs.shape).to(obs.dtype)
    with torch.no_grad():
        mean, _ = vae.encode(torch.stack([m, obs * m / amp], dim=1))
    return mean


def load_vae_prior(path: str, device: Optional[str] = None
                   ) -> Tuple[Callable, int, dict]:
    """(gen_fn, latent_dim, variables) from a VAE checkpoint directory
    (the JAX package's orbax layout), its architecture from the scalar
    leaves the JAX package stores beside the weights."""
    state = dict(load_checkpoint(path))
    latent = int(state.pop("latent_dim", 64))
    beta = float(state.pop("beta", 0.5))
    amp = float(state.pop("amp", DEFAULT_AMP))
    head = HEAD_CODES[int(state.pop("head_code", 0))]
    dec_width = int(state.pop("dec_width", 16))
    refine_width = int(state.pop("refine_width", 0))
    gen = make_vae_generator(state, latent, beta, amp, head, dec_width,
                             refine_width, device=device)
    return gen, latent, state
