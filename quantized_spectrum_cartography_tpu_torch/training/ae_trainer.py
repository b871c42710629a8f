"""The completion autoencoder (the Nasdac / DeepComp prior and the
DowJons-AE S-steps): its training, and its use by the harness.

Port of ``quantized_spectrum_cartography_tpu/training/ae_trainer.py``.
`train_ae` trains the `Autoencoder` on masked simulator maps (mask, masked
map -> map) with a peak-weighted MSE and Adam, from flax's initial weights,
and saves the JAX trainer's ``final`` tree with its `scale`.  The closures
(`make_ae_completer`, `make_ae_latent_fns`, `make_ae_input_fn`) run the
NCHW `Autoencoder` on the JAX functions' layouts ([..., I, J] maps, the
network input as [..., I, J, 2]), converting at the model call.  Leading
axes are batch axes, run through the network in chunks of `chunk` maps.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from quantized_spectrum_cartography_tpu_torch.config import PhysicsConfig
from quantized_spectrum_cartography_tpu_torch.data.datasets import (
    MaskDraws,
    SLFBatchConfig,
    draw_slf,
    make_slf_sampler,
    mask_batch,
)
from quantized_spectrum_cartography_tpu_torch.models import Autoencoder
from quantized_spectrum_cartography_tpu_torch.models.layers import flax_init_
from quantized_spectrum_cartography_tpu_torch.training.checkpoints import (
    flax_from_state_dict,
    load_checkpoint,
    save_checkpoint,
    state_dict_from_flax,
)
from quantized_spectrum_cartography_tpu_torch.training.gan_trainer import adam

CHUNK = 4096


@dataclasses.dataclass(frozen=True)
class AETrainConfig:
    batch_size: int = 64
    lr: float = 1e-3
    steps: int = 10000
    activation: str = "selu"
    onebit_input: bool = False   # SLFDataset1bit-style +-1 inputs
    # The decoder head is a sigmoid, so targets live in [0, 1): simulator
    # SLFs are Frobenius-normalized with peak ~0.26 (p99 0.31); x2.5 fills
    # the sigmoid range (a larger scale makes peaks unrepresentable).
    scale: float = 2.5
    # Loss weight 1 + peak_weight * target / max(target): peak events live
    # on a handful of pixels, which unweighted MSE underweights.
    peak_weight: float = 4.0
    # 'slf'   — single spatial loss fields (the Nasdac per-emitter input)
    # 'band'  — single frequency bands of full rank-R maps (mixtures), the
    #           DeepComp per-band completion input (deep_comp.py:21-42)
    # 'mixed' — the first half of each batch 'slf', the rest 'band'
    data_mode: str = "slf"


class AEDraws(NamedTuple):
    """One step's draws: the maps' (the data mode's sampler's `draws`) and
    the masks'."""

    maps: Any
    mask: MaskDraws


def make_ae_sampler(cfg: AETrainConfig, physics: PhysicsConfig, device):
    """Fn (generator, n, draws=None) -> maps [n, I, J] of the data mode.
    'band' maps are sum_r |N_r| 0.3 S_r over R = physics.num_emitters SLFs,
    its draws (SLFDraws of n*R SLFs, standard normals [n, R]); 'mixed'
    draws are ('slf' draws, 'band' draws)."""
    slf = make_slf_sampler(physics, device)
    R, I = physics.num_emitters, physics.grid_size

    def band(generator, n, draws=None):
        if draws is None:
            draws = (draw_slf(generator, n * R, physics),
                     torch.randn(n, R, generator=generator,
                                 device=generator.device))
        slfs = slf(None, n * R, draws[0]).reshape(n, R, I, I)
        w = draws[1].abs()[..., None, None] * 0.3
        return (slfs * w).sum(dim=1)

    def mixed(generator, n, draws=None):
        half = n // 2
        d_slf, d_band = draws if draws is not None else (None, None)
        return torch.cat([slf(generator, half, d_slf),
                          band(generator, n - half, d_band)])

    return {"slf": slf, "band": band, "mixed": mixed}[cfg.data_mode]


def ae_loss(model: Autoencoder, inp: torch.Tensor, target: torch.Tensor,
            peak_weight: float) -> torch.Tensor:
    """Peak-weighted MSE of the completion: weight 1 + peak_weight *
    target / max(target) per map."""
    peak = target.amax(dim=(1, 2, 3), keepdim=True)
    w = 1.0 + peak_weight * target / peak.clamp_min(1e-12)
    return (w * (model(inp) - target).square()).mean()


def train_ae(
    generator: torch.Generator,
    cfg: AETrainConfig = AETrainConfig(),
    physics: PhysicsConfig = PhysicsConfig(),
    checkpoint_dir: Optional[str] = None,
    log_every: int = 200,
    log_fn=print,
    draws=None,
    model: Optional[Autoencoder] = None,
) -> Tuple[Autoencoder, Dict[str, Any]]:
    """A training run on the generator's device; returns (the autoencoder
    in eval mode, {"metrics": [(step, loss)] every `log_every`, "scale"}).
    With `checkpoint_dir`: ``final`` = {"params", "batch_stats", "scale"},
    the tree `load_ae` reads.  `model` (default: a fresh one, flax's
    initial weights from `generator`) is trained in place; `draws`, a list
    of one `AEDraws` per step, replaces the generator's numbers."""
    if model is None:
        model = flax_init_(Autoencoder(activation=cfg.activation).to(
            generator.device), generator)
    model.train()
    opt = adam(model.parameters(), cfg.lr)
    sampler = make_ae_sampler(cfg, physics, next(model.parameters()).device)
    bcfg = SLFBatchConfig(batch_size=cfg.batch_size, onebit=cfg.onebit_input)

    hist = []
    for i in range(cfg.steps):
        d = draws[i] if draws is not None else AEDraws(None, None)
        maps = sampler(generator, cfg.batch_size, d.maps) * cfg.scale
        inp, target = mask_batch(generator, maps, bcfg, d.mask)
        loss = ae_loss(model, inp, target, cfg.peak_weight)
        opt.zero_grad()
        loss.backward()
        opt.step()
        if (i + 1) % log_every == 0:
            hist.append((i + 1, loss.item()))
            log_fn(f"ae step {i + 1}: mse {hist[-1][1]:.6f}")
    if checkpoint_dir:
        save_checkpoint(f"{checkpoint_dir}/final", {
            **flax_from_state_dict(model.state_dict()), "scale": cfg.scale})
    return model.eval(), {"metrics": hist, "scale": cfg.scale}


def load_ae(path: str, activation: str = "selu",
            device: Optional[str] = None) -> Tuple[Autoencoder, float]:
    """(Autoencoder with the checkpoint's weights, its training `scale`)
    from a completion-AE checkpoint directory of the JAX package.  The
    activation is an architecture choice the checkpoint does not store."""
    state = dict(load_checkpoint(path))
    scale = float(state.pop("scale"))
    model = Autoencoder(activation=activation)
    model.load_state_dict(state_dict_from_flax(state))
    return model.to(device), scale


def _frozen(model: Autoencoder) -> Autoencoder:
    return model.eval().requires_grad_(False)


def _chunked(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
             item_dims: int, chunk: int) -> torch.Tensor:
    """fn over the leading axes of x flattened and split into chunks; each
    item is x's last `item_dims` axes."""
    lead = x.shape[:x.ndim - item_dims]
    flat = x.reshape(-1, *x.shape[x.ndim - item_dims:])
    out = torch.cat([fn(c) for c in flat.split(chunk)])
    return out.reshape(*lead, *out.shape[1:])


def make_ae_completer(model: Autoencoder, scale: float, chunk: int = CHUNK):
    """Fn (mask [..., I, J], observed [..., I, J]) -> completed maps
    [..., I, J] — the DeepComp one-shot completion
    (`backup/algorithms/deep_comp.py:21-42`); mask broadcasts to observed."""
    model = _frozen(model)

    def complete(mask: torch.Tensor, observed: torch.Tensor) -> torch.Tensor:
        m = torch.broadcast_to(mask.to(observed.dtype), observed.shape)
        inp = torch.stack([m, observed * m * scale], dim=-3)
        return _chunked(model, inp, 3, chunk)[..., 0, :, :] / scale

    return complete


def make_ae_latent_fns(model: Autoencoder, scale: float, chunk: int = CHUNK):
    """(encode, decode) for the committed-reference DowJons S-step
    (`joint_opt_ae.m:29` use_gan=false -> `nn_descent_ae.py:
    run_descent_ae`, Adam on the AE's latent code through the decoder).

    encode: (mask [..., I, J], S [..., I, J] raw SLF amplitude) -> z
    [..., latent]; decode: z [..., latent] -> S [..., I, J] raw amplitude
    (the training `scale` is internal to both)."""
    model = _frozen(model)

    def encode(mask: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
        m = torch.broadcast_to(mask.to(S.dtype), S.shape)
        inp = torch.stack([m, S * m * scale], dim=-3)
        return _chunked(model.encode, inp, 3, chunk)

    def decode(z: torch.Tensor) -> torch.Tensor:
        return _chunked(model.decode, z, 1, chunk)[..., 0, :, :] / scale

    return encode, decode


def make_ae_input_fn(model: Autoencoder, scale: float, chunk: int = CHUNK):
    """The network on its own input — the variable
    `solvers.completion.run_descent_ae` optimizes (nn_descent_ae.py:106):
    x [..., I, J, 2] (mask channel, scale * map channel) -> completed SLFs
    [..., I, J]."""
    model = _frozen(model)

    def apply(x: torch.Tensor) -> torch.Tensor:
        return _chunked(model, x.movedim(-1, -3), 3,
                        chunk)[..., 0, :, :] / scale

    return apply
