"""Variational autoencoder (and the beta variant) over SLF maps.

Port of ``quantized_spectrum_cartography_tpu/models/vae.py``, NCHW: the
`models.ae` encoder, Dense mean and log-std heads, a Dense up to 256, the
`models.ae` decoder.  Random draws come from an explicit
``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from quantized_spectrum_cartography_tpu_torch.models.ae import Decoder, Encoder


class VAE(nn.Module):
    def __init__(self, latent_dim: int = 64, activation: str = "leaky_relu",
                 beta: float = 1.0, head: str = "sigmoid",
                 dec_width: int = 16, refine_width: int = 0):
        super().__init__()
        self.latent_dim, self.beta = latent_dim, beta
        self.encoder = Encoder(activation=activation)
        width = self.encoder.out_features
        self.mean_head = nn.Linear(width, latent_dim)
        self.logstd_head = nn.Linear(width, latent_dim)
        self.latent_up = nn.Linear(latent_dim, 256)
        self.decoder = Decoder(activation=activation, head=head,
                               base_width=dec_width,
                               refine_width=refine_width)

    def encode(self, x: torch.Tensor):
        """(mask, map) [B, 2, 51, 51] -> (mean, logstd) [B, latent]."""
        h = self.encoder(x)
        return self.mean_head(h), self.logstd_head(h)

    @staticmethod
    def reparameterize(mean: torch.Tensor, logstd: torch.Tensor,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
        """z = mean + exp(logstd) * eps, eps ~ N(0, I) from `generator`."""
        eps = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                          device=mean.device)
        return mean + torch.exp(logstd) * eps

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z [B, latent] -> maps [B, 1, 51, 51]."""
        return self.decoder(self.latent_up(z))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        mean, logstd = self.encode(x)
        z = self.reparameterize(mean, logstd, generator)
        return self.decode(z), mean, logstd

    def sample(self, n: int,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """n maps decoded from z ~ N(0, I)."""
        device = self.latent_up.weight.device
        z = torch.randn(n, self.latent_dim, generator=generator,
                        device=device)
        return self.decode(z)

    def reconstruct(self, x: torch.Tensor) -> torch.Tensor:
        """Posterior-mean reconstruction."""
        mean, _ = self.encode(x)
        return self.decode(mean)

    def loss(self, recon, target, mean, logstd):
        """(total, BCE, KL) per example: BCE of the clipped reconstruction
        plus beta times the KL 0.5 * sum(mean^2 + exp(2 logstd) - 2 logstd
        - 1)."""
        eps = 1e-7
        r = recon.clamp(eps, 1.0 - eps)
        bce = -(target * torch.log(r) + (1 - target) * torch.log(1 - r)).sum()
        kl = 0.5 * (mean.square() + torch.exp(2.0 * logstd) - 2.0 * logstd
                    - 1.0).sum()
        b = recon.shape[0]
        return (bce + self.beta * kl) / b, bce / b, kl / b


def betaVAE(latent_dim: int = 64, beta: float = 4.0) -> VAE:
    return VAE(latent_dim=latent_dim, beta=beta)
