"""VAE / betaVAE training on simulator batches.

Port of ``quantized_spectrum_cartography_tpu/training/vae_trainer.py``
(itself the reference's pytorch-lightning loop, ``deep_prior/networks/
vae.py:199-286``): Adam with the learning rate halved in stairs
(``StepLR``), a KL weight warmed up from 0 to beta, free bits, an MSE or
(peak-weighted) BCE data term on peak-normalized targets, and an optional
exponential moving average of the weights.  Weights start as flax
initializes them; ``final`` holds {"params", "batch_stats"}, the tree
``solvers.vae_prior.load_vae_prior`` reads.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from quantized_spectrum_cartography_tpu_torch.config import PhysicsConfig
from quantized_spectrum_cartography_tpu_torch.data.datasets import (
    MaskDraws,
    SLFBatchConfig,
    SLFDraws,
    make_slf_sampler,
    mask_batch,
)
from quantized_spectrum_cartography_tpu_torch.models import VAE
from quantized_spectrum_cartography_tpu_torch.models.layers import flax_init_
from quantized_spectrum_cartography_tpu_torch.training.checkpoints import (
    flax_from_state_dict,
    save_checkpoint,
)
from quantized_spectrum_cartography_tpu_torch.training.gan_trainer import adam


@dataclasses.dataclass(frozen=True)
class VAETrainConfig:
    latent_dim: int = 64
    beta: float = 1.0
    batch_size: int = 64
    lr: float = 1e-3
    lr_decay_steps: int = 2000   # StepLR (vae.py:205-208)
    lr_decay_rate: float = 0.5
    steps: int = 10000
    scale: float = 50.0
    kl_warmup_steps: int = 3000   # KL weight 0 -> beta: without it most
                                  # seeds posterior-collapse
    free_bits: float = 0.1        # per-latent-dim KL floor (nats); 0
                                  # disables
    ema_decay: float = 0.0        # EMA of the weights; 0 disables
    peak_weight: float = 0.0      # data-term weight 1 + pw * target
                                  # (targets peak-normalized); 0 disables
    head: str = "sigmoid"         # decoder output head (models/ae.Decoder)
    dec_width: int = 16           # decoder channel-width multiplier base
    refine_width: int = 0         # full-resolution refinement block width
    recon: str = "bce"            # data term: 'bce' (sigmoid head) or 'mse'


class VAEDraws(NamedTuple):
    """One step's draws: the maps', the masks' and the reparameterization
    noise `eps` [B, latent] (standard normals)."""

    maps: SLFDraws
    mask: MaskDraws
    eps: torch.Tensor


def vae_model(cfg: VAETrainConfig) -> VAE:
    """The VAE of a training configuration (weights torch's defaults)."""
    return VAE(latent_dim=cfg.latent_dim, beta=cfg.beta, head=cfg.head,
               dec_width=cfg.dec_width, refine_width=cfg.refine_width)


def _batch(sampler, bcfg, generator, draws: Optional[VAEDraws], latent: int):
    """(input, target, eps) of one batch of peak-normalized masked maps."""
    d = draws if draws is not None else VAEDraws(None, None, None)
    maps = sampler(generator, bcfg.batch_size, d.maps)
    inp, target = mask_batch(generator, maps, bcfg, d.mask)
    eps = d.eps if d.eps is not None else torch.randn(
        maps.shape[0], latent, generator=generator, device=maps.device)
    return inp, target, eps


def _forward(vae: VAE, inp: torch.Tensor, eps: torch.Tensor):
    """(recon, mean, logstd), z = mean + exp(logstd) eps."""
    mean, logstd = vae.encode(inp)
    return vae.decode(mean + torch.exp(logstd) * eps), mean, logstd


def vae_loss(vae: VAE, inp: torch.Tensor, target: torch.Tensor,
             eps: torch.Tensor, cfg: VAETrainConfig, kl_w: float):
    """(objective, bce, kl) of one batch: the data term (MSE, or BCE
    weighted by 1 + peak_weight * target), plus kl_w * beta times the KL
    with free bits; `bce` and `kl` are the plain terms, as logged."""
    recon, mean, logstd = _forward(vae, inp, eps)
    _, bce, kl = vae.loss(recon, target, mean, logstd)
    w = 1.0 + cfg.peak_weight * target
    B = recon.shape[0]
    if cfg.recon == "mse":
        bce_obj = (w * (recon - target).square()).sum() / B
    elif cfg.peak_weight > 0.0:
        r = recon.clamp(1e-7, 1.0 - 1e-7)
        bce_obj = -(w * (target * torch.log(r) + (1.0 - target)
                         * torch.log(1.0 - r))).sum() / B
    else:
        bce_obj = bce
    if cfg.free_bits > 0.0:
        # per-dim batch-mean KL floored at the free bits
        kl_dims = 0.5 * (mean.square() + torch.exp(2.0 * logstd)
                         - 2.0 * logstd - 1.0).mean(dim=0)
        kl_obj = kl_dims.clamp_min(cfg.free_bits).sum()
    else:
        kl_obj = kl
    return bce_obj + kl_w * cfg.beta * kl_obj, bce, kl


def train_vae(
    generator: Optional[torch.Generator],
    cfg: VAETrainConfig = VAETrainConfig(),
    physics: PhysicsConfig = PhysicsConfig(),
    checkpoint_dir: Optional[str] = None,
    log_every: int = 200,
    log_fn=print,
    draws: Optional[List[VAEDraws]] = None,
    model: Optional[VAE] = None,
) -> Tuple[VAE, Dict[str, Any]]:
    """A training run on the generator's device; returns (the VAE in eval
    mode, {"metrics": [(step, total, bce, kl)] every `log_every`, and with
    ``ema_decay`` > 0 "variables_ema", a state_dict of the EMA weights
    beside the running statistics}).  `model` (default: a fresh one,
    flax's initial weights from `generator`) is trained in place; `draws`,
    one `VAEDraws` per step, replaces the generator's numbers."""
    if model is None:
        model = flax_init_(vae_model(cfg).to(generator.device), generator)
    model.train()
    device = next(model.parameters()).device
    opt = adam(model.parameters(), cfg.lr)
    sched = torch.optim.lr_scheduler.StepLR(opt, cfg.lr_decay_steps,
                                            cfg.lr_decay_rate)
    sampler = make_slf_sampler(physics, device)
    bcfg = SLFBatchConfig(batch_size=cfg.batch_size, normalize_peak=True)
    params = dict(model.named_parameters())
    ema = {k: p.detach().clone() for k, p in params.items()}

    hist = []
    for i in range(cfg.steps):
        inp, target, eps = _batch(sampler, bcfg, generator,
                                  draws[i] if draws is not None else None,
                                  cfg.latent_dim)
        kl_w = float(np.clip(np.float32(i) / np.float32(
            max(cfg.kl_warmup_steps, 1)), 0.0, 1.0))
        total, bce, kl = vae_loss(model, inp, target, eps, cfg, kl_w)
        opt.zero_grad()
        total.backward()
        opt.step()
        sched.step()
        if cfg.ema_decay > 0.0:
            with torch.no_grad():
                for k, p in params.items():
                    ema[k].mul_(cfg.ema_decay).add_(p,
                                                    alpha=1.0 - cfg.ema_decay)
        if (i + 1) % log_every == 0:
            hist.append((i + 1, total.item(), bce.item(), kl.item()))
            log_fn(f"vae step {i + 1}: loss {hist[-1][1]:.4f} "
                   f"bce {hist[-1][2]:.4f} kl {hist[-1][3]:.4f}")
    if checkpoint_dir:
        save_checkpoint(f"{checkpoint_dir}/final",
                        flax_from_state_dict(model.state_dict()))
    info: Dict[str, Any] = {"metrics": hist}
    if cfg.ema_decay > 0.0:
        info["variables_ema"] = {**model.state_dict(), **ema}
    return model.eval(), info


@torch.no_grad()
def heldout_elbo(
    cfg: VAETrainConfig,
    model: VAE,
    physics: PhysicsConfig = PhysicsConfig(),
    generator: Optional[torch.Generator] = None,
    batches: int = 8,
    draws: Optional[List[VAEDraws]] = None,
) -> Dict[str, float]:
    """Held-out ELBO terms of `model` (eval mode) on fresh simulator
    batches (default: a generator seeded 987654 on the model's device, or
    `draws`, one `VAEDraws` per batch): {"bce", "kl", "elbo_loss" = bce +
    beta kl}, each the mean over batches — a training-time criterion for
    choosing among checkpoints."""
    device = next(model.parameters()).device
    if generator is None and draws is None:
        generator = torch.Generator(device=device).manual_seed(987_654)
    model.eval()
    sampler = make_slf_sampler(physics, device)
    bcfg = SLFBatchConfig(batch_size=cfg.batch_size, normalize_peak=True)
    bces, kls = [], []
    for i in range(batches):
        inp, target, eps = _batch(sampler, bcfg, generator,
                                  draws[i] if draws is not None else None,
                                  cfg.latent_dim)
        recon, mean, logstd = _forward(model, inp, eps)
        _, bce, kl = model.loss(recon, target, mean, logstd)
        bces.append(bce.item())
        kls.append(kl.item())
    bce = float(np.mean(np.asarray(bces, np.float32)))
    kl = float(np.mean(np.asarray(kls, np.float32)))
    return {"bce": bce, "kl": kl, "elbo_loss": bce + cfg.beta * kl}
