"""Adversarial-autoencoder training on simulator batches.

Port of ``quantized_spectrum_cartography_tpu/training/aae_trainer.py``.
Each step:
  1. AE update:       min_{E,D} ||x - D(E(x))||^2        (Adam, lr_ae)
  2. latent D update: max_Dz log Dz(z ~ N(0, I)) + log(1 - Dz(E(x)))
  3. encoder update:  min_E -adv_weight log Dz(E(x))      (fool the critic)
with three Adams, two of them over the encoder's weights; steps 2 and 3
run the encoder in eval mode, on the running statistics step 1 moved.  The
checkpoint is the JAX trainer's: the directory itself holds {"enc", "dec",
"dz", "enc_stats", "dec_stats", "config"}.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from quantized_spectrum_cartography_tpu_torch.config import PhysicsConfig
from quantized_spectrum_cartography_tpu_torch.data.datasets import (
    SLFDraws,
    make_slf_sampler,
)
from quantized_spectrum_cartography_tpu_torch.models.aae import (
    AAEDecoder,
    AAEEncoder,
    LatentDiscriminator,
)
from quantized_spectrum_cartography_tpu_torch.models.layers import flax_init_
from quantized_spectrum_cartography_tpu_torch.training.checkpoints import (
    flax_from_state_dict,
    save_checkpoint,
)
from quantized_spectrum_cartography_tpu_torch.training.gan_trainer import (
    _bce,
    adam,
)


@dataclasses.dataclass(frozen=True)
class AAETrainConfig:
    z_dim: int = 64
    batch_size: int = 64
    lr_ae: float = 1e-3
    lr_adv: float = 5e-4
    steps: int = 10000
    scale: float = 2.5        # amplitude match, like gan_trainer.scale
    adv_weight: float = 0.1   # encoder's fooling term vs reconstruction


class AAEDraws(NamedTuple):
    """One step's draws: the batch's SLFs and the prior's z [B, z_dim]
    (standard normals)."""

    x: SLFDraws
    z_real: torch.Tensor


def init_aae(generator: torch.Generator, cfg: AAETrainConfig):
    """(encoder, decoder, latent discriminator, (AE Adam, Dz Adam, encoder
    Adam)), on the generator's device in train mode, weights drawn from
    `generator` as flax draws them."""
    dev = generator.device
    enc = flax_init_(AAEEncoder(z_dim=cfg.z_dim).to(dev), generator)
    dec = flax_init_(AAEDecoder(z_dim=cfg.z_dim).to(dev), generator)
    dz = flax_init_(LatentDiscriminator(z_dim=cfg.z_dim).to(dev), generator)
    return enc, dec, dz, aae_optimizers(enc, dec, dz, cfg)


def aae_optimizers(enc, dec, dz, cfg: AAETrainConfig):
    return (adam([*enc.parameters(), *dec.parameters()], cfg.lr_ae),
            adam(dz.parameters(), cfg.lr_adv),
            adam(enc.parameters(), cfg.lr_adv))


def recon_loss(enc: AAEEncoder, dec: AAEDecoder,
               x: torch.Tensor) -> torch.Tensor:
    """||x - D(E(x))||^2, mean over entries."""
    return (dec(enc(x)) - x).square().mean()


def make_aae_step(enc: AAEEncoder, dec: AAEDecoder, dz: LatentDiscriminator,
                  opts, cfg: AAETrainConfig,
                  physics: PhysicsConfig = PhysicsConfig()):
    """step(generator, draws=None) -> {"recon", "dz", "gen"} (0-d
    tensors)."""
    opt_ae, opt_dz, opt_gen = opts
    sampler = make_slf_sampler(physics, next(enc.parameters()).device)

    def step(generator: Optional[torch.Generator] = None,
             draws: Optional[AAEDraws] = None) -> Dict[str, torch.Tensor]:
        d = draws if draws is not None else AAEDraws(None, None)
        x = sampler(generator, cfg.batch_size, d.x)[:, None] * cfg.scale

        # 1. reconstruction update of (E, D)
        enc.train()
        dec.train()
        rl = recon_loss(enc, dec, x)
        opt_ae.zero_grad()
        rl.backward()
        opt_ae.step()

        # 2. latent discriminator: prior z against the encoder's
        enc.eval()
        with torch.no_grad():
            z_fake = enc(x)
        z_real = d.z_real if d.z_real is not None else torch.randn(
            z_fake.shape, generator=generator, device=z_fake.device)
        dl = _bce(dz(z_real), 1.0) + _bce(dz(z_fake), 0.0)
        opt_dz.zero_grad()
        dl.backward()
        opt_dz.step()

        # 3. the encoder fools the critic
        dz.requires_grad_(False)
        try:
            gl = cfg.adv_weight * _bce(dz(enc(x)), 1.0)
            opt_gen.zero_grad()
            gl.backward()
            opt_gen.step()
        finally:
            dz.requires_grad_(True)
            enc.train()
        return {"recon": rl.detach(), "dz": dl.detach(), "gen": gl.detach()}

    return step


def train_aae(
    generator: torch.Generator,
    cfg: AAETrainConfig = AAETrainConfig(),
    physics: PhysicsConfig = PhysicsConfig(),
    checkpoint_dir: Optional[str] = None,
    log_every: int = 500,
    log_fn=print,
) -> Tuple[AAEDecoder, AAEEncoder, LatentDiscriminator, Dict[str, float]]:
    """A training run on the generator's device; returns (decoder, encoder,
    latent discriminator, the last step's metrics).  The decoder is a
    generative prior (z ~ N(0, I)); the encoder gives an amortized latent
    start."""
    enc, dec, dz, opts = init_aae(generator, cfg)
    step = make_aae_step(enc, dec, dz, opts, cfg, physics)
    metrics: Dict[str, torch.Tensor] = {}
    for i in range(cfg.steps):
        metrics = step(generator)
        if log_every and (i % log_every == 0 or i == cfg.steps - 1):
            log_fn(f"aae step {i}: recon {metrics['recon'].item():.5f} "
                   f"dz {metrics['dz'].item():.4f} "
                   f"gen {metrics['gen'].item():.4f}")
    if checkpoint_dir:
        e, de = (flax_from_state_dict(m.state_dict()) for m in (enc, dec))
        save_checkpoint(checkpoint_dir, {
            "enc": e["params"], "dec": de["params"],
            "dz": flax_from_state_dict(dz.state_dict())["params"],
            "enc_stats": e["batch_stats"], "dec_stats": de["batch_stats"],
            "config": dataclasses.asdict(cfg)})
    return (dec.eval(), enc.eval(), dz,
            {k: v.item() for k, v in metrics.items()})
