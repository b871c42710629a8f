"""SNGAN training of the SLF deep prior (Generator256 against the spectrally
normalized discriminator), on simulator batches.

Port of ``quantized_spectrum_cartography_tpu/training/gan_trainer.py``: one
step updates D, then G, with Adam (b1 0.5).  Running statistics move as in
the JAX step: D's BatchNorm statistics and spectral vectors only in the D
step's pass on the real batch (the fake pass and the G step's pass run in
train mode under `frozen_stats`); G's BatchNorm statistics twice, in the
D step's and in the G step's forward.  Weights start as flax initializes
them (`models.layers.flax_init_`); checkpoints hold the generator's flax
tree and its output `scale`, as the JAX trainer's do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from quantized_spectrum_cartography_tpu_torch.config import PhysicsConfig
from quantized_spectrum_cartography_tpu_torch.data.datasets import (
    SLFDraws,
    make_slf_sampler,
)
from quantized_spectrum_cartography_tpu_torch.models import (
    DCGANGenerator,
    Discriminator,
    make_generator,
)
from quantized_spectrum_cartography_tpu_torch.models.layers import (
    flax_init_,
    frozen_stats,
)
from quantized_spectrum_cartography_tpu_torch.training.checkpoints import (
    flax_from_generator,
    save_checkpoint,
)


@dataclasses.dataclass(frozen=True)
class GANTrainConfig:
    z_dim: int = 256
    batch_size: int = 64
    lr_g: float = 2e-4
    lr_d: float = 1e-4           # D below G: with amplitude-matched data
                                 # the D otherwise wins early and G stalls
    beta1: float = 0.5           # DCGAN convention
    steps: int = 20000
    spectral_norm: bool = True
    scale: float = 2.5           # SLF peak ~0.26 (p99 0.31); x2.5 fills the
                                 # sigmoid range without clipping; divided
                                 # back out at inference
    real_label: float = 0.9      # one-sided label smoothing
    loss: str = "bce"            # 'bce' (reference DCGAN recipe) or 'hinge'
                                 # (D on raw scores, relu(1 -/+ score))


class GANDraws(NamedTuple):
    """One step's draws: the real batch's SLFs, the D step's latents
    `z1` and the G step's `z2` (standard normals [B, z_dim])."""

    real: SLFDraws
    z1: torch.Tensor
    z2: torch.Tensor


def adam(params, lr: float, b1: float = 0.9) -> torch.optim.Adam:
    """``optax.adam(lr, b1)``: b2 0.999, eps 1e-8 added to sqrt(v_hat)."""
    return torch.optim.Adam(params, lr=lr, betas=(b1, 0.999), eps=1e-8)


def init_gan(generator: torch.Generator, cfg: GANTrainConfig):
    """(G, D, G's Adam, D's Adam), on the generator's device in train
    mode, weights drawn from `generator` as flax draws them."""
    dev = generator.device
    g = flax_init_(make_generator(cfg.z_dim).to(dev), generator).train()
    d = flax_init_(Discriminator(spectral_norm=cfg.spectral_norm,
                                 output_logits=(cfg.loss == "hinge")).to(dev),
                   generator).train()
    return (g, d, adam(g.parameters(), cfg.lr_g, cfg.beta1),
            adam(d.parameters(), cfg.lr_d, cfg.beta1))


def _bce(p: torch.Tensor, target: float) -> torch.Tensor:
    """BCE of sigmoid outputs p in (0, 1) against a constant target."""
    p = p.clamp(1e-6, 1.0 - 1e-6)
    return -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p)
             ).mean()


def _image(x: torch.Tensor) -> torch.Tensor:
    """The generator's [B, 51, 51, 1] as the discriminator's NCHW."""
    return x.permute(0, 3, 1, 2)


def d_loss(d: Discriminator, real: torch.Tensor, fake: torch.Tensor,
           cfg: GANTrainConfig) -> torch.Tensor:
    """The D step's loss on a real and a fake batch [B, 1, 51, 51]: the
    real pass moves D's running statistics and spectral vectors, the fake
    pass (on the vectors the real pass wrote) does not."""
    p_real = d(real)
    with frozen_stats(d):
        p_fake = d(fake)
    if cfg.loss == "hinge":
        return (torch.relu(1.0 - p_real).mean()
                + torch.relu(1.0 + p_fake).mean())
    return _bce(p_real, cfg.real_label) + _bce(p_fake, 0.0)


def g_loss(g: DCGANGenerator, d: Discriminator, z: torch.Tensor,
           cfg: GANTrainConfig) -> torch.Tensor:
    """The G step's loss on latents z: G's forward moves its running
    statistics, D's pass (train mode) moves none of D's."""
    with frozen_stats(d):
        p_fake = d(_image(g(z)))
    return -p_fake.mean() if cfg.loss == "hinge" else _bce(p_fake, 1.0)


def make_train_step(g: DCGANGenerator, d: Discriminator, opt_g, opt_d,
                    cfg: GANTrainConfig, sampler):
    """step(generator, draws=None) -> {"d_loss", "g_loss"} (0-d tensors):
    one D update, then one G update, on a real batch of
    `sampler(generator, B)` x scale and latents drawn from `generator`
    (or `draws`, a `GANDraws`)."""

    def step(generator: Optional[torch.Generator] = None,
             draws: Optional[GANDraws] = None) -> Dict[str, torch.Tensor]:
        dr = draws if draws is not None else GANDraws(None, None, None)

        def latents(z):
            return z if z is not None else torch.randn(
                cfg.batch_size, cfg.z_dim, generator=generator,
                device=generator.device)

        real = sampler(generator, cfg.batch_size, dr.real)[:, None] \
            * cfg.scale

        # --- D step ---
        with torch.no_grad():
            fake = _image(g(latents(dr.z1)))
        loss_d = d_loss(d, real, fake, cfg)
        opt_d.zero_grad()
        loss_d.backward()
        opt_d.step()

        # --- G step ---
        d.requires_grad_(False)
        try:
            loss_g = g_loss(g, d, latents(dr.z2), cfg)
            opt_g.zero_grad()
            loss_g.backward()
            opt_g.step()
        finally:
            d.requires_grad_(True)
        return {"d_loss": loss_d.detach(), "g_loss": loss_g.detach()}

    return step


def train_gan(
    generator: torch.Generator,
    cfg: GANTrainConfig = GANTrainConfig(),
    physics: PhysicsConfig = PhysicsConfig(),
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 5000,
    log_every: int = 200,
    log_fn=print,
) -> Tuple[DCGANGenerator, Dict[str, Any]]:
    """A training run on the generator's device; returns (the generator in
    eval mode, {"metrics": [(step, d_loss, g_loss)] every `log_every`,
    "scale"}).  With `checkpoint_dir`: ``step_<n>`` every
    `checkpoint_every` steps and ``final``, each {"params", "batch_stats",
    "scale"}, the tree ``load_generator`` reads (divide its outputs by
    `scale`, as the CLI does)."""
    g, d, opt_g, opt_d = init_gan(generator, cfg)
    sampler = make_slf_sampler(physics, generator.device)
    step = make_train_step(g, d, opt_g, opt_d, cfg, sampler)

    def save(name):
        save_checkpoint(f"{checkpoint_dir}/{name}",
                        {**flax_from_generator(g), "scale": cfg.scale})

    hist = []
    for i in range(cfg.steps):
        m = step(generator)
        if (i + 1) % log_every == 0:
            hist.append((i + 1, m["d_loss"].item(), m["g_loss"].item()))
            log_fn(f"gan step {i + 1}: d_loss {hist[-1][1]:.4f} "
                   f"g_loss {hist[-1][2]:.4f}")
        if checkpoint_dir and (i + 1) % checkpoint_every == 0:
            save(f"step_{i + 1}")
    if checkpoint_dir:
        save("final")
    return g.eval(), {"metrics": hist, "scale": cfg.scale}
