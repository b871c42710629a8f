"""Training batches drawn from the simulator: SLF maps with random masks.

Port of ``quantized_spectrum_cartography_tpu/data/datasets.py`` (the
reference's ``SLFDataset``, ``SLFDataset1bit`` and ``GANSample``,
``deep_prior/slf_dataset.py``): maps come from the physics simulator as one
batch on the generator's device, never one sample at a time, and from no
dataset files.  Layout NCHW: `mask_batch` gives (mask, masked map) as
[B, 2, I, J] and the target as [B, 1, I, J] (the JAX package's NHWC
[B, I, J, 2] and [B, I, J, 1]).

Every function that draws takes a ``torch.Generator`` and, as ``draws``, the
numbers it would draw (uniforms in [0, 1) and standard normals, see
`SLFDraws` and `MaskDraws`), so that a caller can hand it another source's
numbers; the maps are a deterministic function of them.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import (Callable, Iterator, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from quantized_spectrum_cartography_tpu_torch.config import PhysicsConfig


@dataclasses.dataclass(frozen=True)
class SLFBatchConfig:
    batch_size: int = 64
    sample_lo: float = 0.01     # sample_size=[0.01, 0.20] (slf_dataset.py:73)
    sample_hi: float = 0.20
    onebit: bool = False        # SLFDataset1bit thresholding
    mean_slf: float = 0.0045
    normalize_peak: bool = False  # scale each SLF so max == 1


class SLFDraws(NamedTuple):
    """A batch of SLFs' draws: `loc` [B, 2] and `alpha` [B] uniforms,
    `shadow` [B, I*I] standard normals."""

    loc: torch.Tensor
    alpha: torch.Tensor
    shadow: torch.Tensor


class MaskDraws(NamedTuple):
    """A batch's mask draws, uniforms: `rate` [B], `mask` [B, I, J]."""

    rate: torch.Tensor
    mask: torch.Tensor


def draw_slf(generator: torch.Generator, batch: int,
             physics: PhysicsConfig = PhysicsConfig()) -> SLFDraws:
    dev, n = generator.device, physics.grid_size ** 2
    return SLFDraws(
        torch.rand(batch, 2, generator=generator, device=dev),
        torch.rand(batch, generator=generator, device=dev),
        torch.randn(batch, n, generator=generator, device=dev))


def make_slf_sampler(
    physics: PhysicsConfig = PhysicsConfig(), device="cuda",
) -> Callable[..., torch.Tensor]:
    """Fn (generator, batch, draws=None) -> SLFs [B, I, J] on `device`,
    Frobenius-normalized (``physics.simulator.sample_slf`` of the JAX
    package, batched): location (I-1)*U, path-loss exponent alpha_lo +
    spread*U, shadowing unvec(L (sigma N))."""
    # deferred: physics.simulator imports data.fixtures (package cycle)
    from quantized_spectrum_cartography_tpu_torch.physics.shadowing import (
        correlated_field, correlation_cholesky)
    from quantized_spectrum_cartography_tpu_torch.physics.simulator import (
        slf_from_draws)

    I = physics.grid_size
    chol = torch.as_tensor(
        correlation_cholesky(I, physics.decorrelation_distance),
        device=device)

    def sample(generator: Optional[torch.Generator], batch: int,
               draws: Optional[SLFDraws] = None) -> torch.Tensor:
        d = draws if draws is not None else draw_slf(generator, batch,
                                                     physics)
        shadow_db = correlated_field(chol, physics.shadow_sigma * d.shadow, I)
        return slf_from_draws((I - 1.0) * d.loc,
                              physics.alpha_lo + physics.alpha_spread
                              * d.alpha, shadow_db, physics)

    return sample


def draw_mask(generator: torch.Generator, maps: torch.Tensor) -> MaskDraws:
    return MaskDraws(
        torch.rand(maps.shape[0], generator=generator, device=maps.device),
        torch.rand(maps.shape, generator=generator, device=maps.device))


def mask_batch(
    generator: Optional[torch.Generator],
    maps: torch.Tensor,
    cfg: SLFBatchConfig,
    draws: Optional[MaskDraws] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """((mask, masked map) [B, 2, I, J], target [B, 1, I, J]) from maps
    [B, I, J] (SLFDataset.__getitem__, slf_dataset.py:107-127): a Bernoulli
    mask per sample at a rate ~ U[lo, hi]; the 1-bit variant thresholds the
    masked input at mean_slf to +-1, the target stays raw
    (slf_dataset.py:176-195)."""
    d = draws if draws is not None else draw_mask(generator, maps)
    rates = cfg.sample_lo + (cfg.sample_hi - cfg.sample_lo) * d.rate
    mask = (d.mask < rates[:, None, None]).to(maps.dtype)
    target = maps
    if cfg.normalize_peak:
        peak = maps.abs().amax(dim=(1, 2), keepdim=True)
        target = maps / peak.clamp_min(1e-12)
    source = target
    if cfg.onebit:
        source = torch.where(target > cfg.mean_slf, 1.0, -1.0)
    return torch.stack([mask, source * mask], dim=1), target[:, None]


def slf_batches(
    generator: Optional[torch.Generator],
    cfg: SLFBatchConfig = SLFBatchConfig(),
    physics: PhysicsConfig = PhysicsConfig(),
    draws: Optional[Sequence[Tuple[SLFDraws, MaskDraws]]] = None,
) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Infinite iterator of (input, target) completion batches on the
    generator's device; with `draws`, one batch per (maps' draws, masks'
    draws) in it."""
    if draws is None:
        device, draws = generator.device, itertools.repeat((None, None))
    else:
        device = draws[0][0].loc.device
    sampler = make_slf_sampler(physics, device)
    for d_maps, d_mask in draws:
        maps = sampler(generator, cfg.batch_size, d_maps)
        yield mask_batch(generator, maps, cfg, d_mask)


def gan_sample_batch(
    generator: Optional[torch.Generator],
    gen_apply: Callable[[torch.Tensor], torch.Tensor],
    batch: int,
    z_dim: int = 256,
    draws: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(samples, z [B, z_dim]) from a trained generator (the `GANSample`
    dataset, slf_dataset.py:30-67); `draws` is z itself."""
    z = draws if draws is not None else torch.randn(
        batch, z_dim, generator=generator, device=generator.device)
    return gen_apply(z), z


def boundaries_from_samples(
    generator: Optional[torch.Generator],
    num_bins: int = 8,
    num_samples: int = 10000,
    log_domain: bool = False,
    log_offset: float = 1e-10,
    physics: PhysicsConfig = PhysicsConfig(),
    draws: Optional[List[SLFDraws]] = None,
) -> Tuple[np.ndarray, float]:
    """Equal-count bin boundaries of simulator SLFs (the reference's
    `get_boundaries_from_samples`, qmc/utils.py:76-90, without its file
    dataset): maps in chunks of min(num_samples, 512) until num_samples
    maps are drawn; `draws` holds one `SLFDraws` per chunk.  Returns
    (boundaries [num_bins + 1], the smallest gap) like
    ``ops.boundaries.find_boundaries``."""
    from quantized_spectrum_cartography_tpu_torch.ops.boundaries import (
        find_boundaries)

    device = generator.device if draws is None else draws[0].loc.device
    sampler = make_slf_sampler(physics, device)
    chunk = min(num_samples, 512)
    chunks = -(-num_samples // chunk)
    vals = [sampler(generator, chunk,
                    None if draws is None else draws[i]).reshape(-1)
            for i in range(chunks)]
    samples = torch.cat(vals)
    if log_domain:
        samples = torch.log(samples + log_offset)
    return find_boundaries(samples, num_bins=num_bins)
