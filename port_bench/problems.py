"""The cells' inputs and weights, made on the device from the seed.

Everything here is the benchmark's: both the program and the reference are
handed these tensors.  Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from port_bench import traffic
from port_bench.reference.mlegan import generator_forward
from port_bench.reference.numerics import Precision

F32 = Precision(torch.float32, False)


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def onebit_batches(gen, cfg: dict, batch: int, count: int):
    """`count` batches of 1-bit observations y01 [batch, K, I, J] in {0, 1}
    (float32) of simulated maps, dithered at the configuration's threshold
    and sigma."""
    ph, ob = cfg["physics"], cfg["observation"]
    chol = traffic.correlation_cholesky(ph["grid_size"],
                                        ph["decorrelation_distance"],
                                        gen.device)
    out = []
    for _ in range(count):
        T, _, _ = traffic.generate_map_batch(gen, ph, batch, chol)
        out.append(traffic.dither_probit(T - ob["threshold"],
                                         ob["dither_std"], gen))
    return out


def probe(gen, cfg: dict) -> torch.Tensor:
    """The subspace projection's Gaussian probe [I, rank + oversample]."""
    sv = cfg["solver"]
    return torch.randn(cfg["physics"]["grid_size"],
                       sv["rank_truncation"] + sv["oversample"],
                       generator=gen, device=gen.device)


def starts(cfg: dict, batch: int, device):
    """The solver's starts: S0 [B, R, I, J] and C0 [B, R, K], constants."""
    ph, sv = cfg["physics"], cfg["solver"]
    R, K, I = ph["num_emitters"], ph["num_bands"], ph["grid_size"]
    return (torch.full((batch, R, I, I), float(sv["S0"]), device=device),
            torch.full((batch, R, K), float(sv["C0"]), device=device))


def generator_weights(gen, prior: dict) -> dict:
    """DCGAN weights in torch's layouts, drawn in one call: He-scaled
    normal kernels (fan-in of a transposed convolution: in x k^2 / s^2),
    small biases, BatchNorm scales 1 + 0.1 N and shifts 0.1 N.  The running
    statistics are those of a batch of 256 latent draws through the drawn
    weights, so each stage's activations are normalized as in a trained
    prior and the output spreads over (0, 1) with Z."""
    z, stages = prior["z_dim"], prior["stages"]
    f_out, k_out, _, _ = prior["final_conv"]
    spec, width = [], z
    for i, (f, k, s, _) in enumerate(stages):
        spec += [(f"convt.{i}.weight", (width, f, k, k),
                  math.sqrt(2.0 * s * s / (width * k * k)), 0.0),
                 (f"convt.{i}.bias", (f,), 0.01, 0.0),
                 (f"bn.{i}.weight", (f,), 0.1, 1.0),
                 (f"bn.{i}.bias", (f,), 0.1, 0.0)]
        width = f
    spec += [("conv.weight", (f_out, width, k_out, k_out),
              math.sqrt(2.0 / (width * k_out * k_out)), 0.0),
             ("conv.bias", (f_out,), 0.01, 0.0)]
    sizes = [math.prod(shape) for _, shape, _, _ in spec]
    flat = torch.randn(sum(sizes), generator=gen, device=gen.device)
    w = {}
    for (name, shape, scale, shift), part in zip(spec,
                                                 flat.split(sizes)):
        w[name] = part.reshape(shape) * scale + shift
    x = torch.randn(256, z, 1, 1, generator=gen, device=gen.device)
    with torch.no_grad():
        for i, (_, _, s, p) in enumerate(stages):
            x = torch.nn.functional.conv_transpose2d(
                x, w[f"convt.{i}.weight"], w[f"convt.{i}.bias"], s, p)
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            w[f"bn.{i}.running_mean"], w[f"bn.{i}.running_var"] = mean, var
            scale = w[f"bn.{i}.weight"] / torch.sqrt(var + 1e-5)
            x = torch.relu((x - mean[:, None, None]) * scale[:, None, None]
                           + w[f"bn.{i}.bias"][:, None, None])
    return w


def mlegan_problems(gen, cfg: dict, weights: dict, count: int):
    """`count` one-map problems: the truth T = G(z) C with C = |N(0, 1)|
    (a map the prior can realize, as ``chip_smoke.py`` `main_gan` builds
    it), its log-quantized observations Y [K, I, J] (int32 bins), the
    per-entry mask, the start Z_init [R, z] and the search's standard
    normals (global [G, R, z], local [L, R, z])."""
    ph, ob, pr, sv = (cfg["physics"], cfg["observation"], cfg["prior"],
                      cfg["solver"])
    R, K, z = ph["num_emitters"], ph["num_bands"], pr["z_dim"]
    dev = gen.device
    out = []
    for _ in range(count):
        with torch.no_grad():
            S = generator_forward(weights, pr["stages"],
                                  torch.randn(R, z, generator=gen,
                                              device=dev), F32)
        C = torch.randn(R, K, generator=gen, device=dev).abs()
        T = torch.einsum("rij,rk->kij", S, C)
        Y = traffic.quantize_log(T, ob["noise_std"], ob["boundaries"],
                                 ob["log_offset"], gen)
        mask = traffic.sample_entry_mask(gen, tuple(Y.shape),
                                         ob["mask_fraction"])
        out.append({
            "Y": Y, "mask": mask,
            "Z_init": torch.randn(R, z, generator=gen, device=dev),
            "draws": (torch.randn(sv["z_search_global"], R, z,
                                  generator=gen, device=dev),
                      torch.randn(sv["z_search_local"], R, z,
                                  generator=gen, device=dev)),
        })
    return out


def packed_requests(gen, cfg: dict, count: int) -> np.ndarray:
    """`count` single-map 1-bit requests, bit-packed on the host:
    uint8 [count, K, ceil(I*J / 8)]."""
    y01 = onebit_batches(gen, cfg, count, 1)[0]
    n, K = y01.shape[:2]
    return traffic.pack_bits_host(y01.reshape(n, K, -1).cpu().numpy())


def unpack_host(packed: np.ndarray, cfg: dict) -> np.ndarray:
    """The benchmark's own reading of its requests: y01 [.., K, I, J]."""
    I = cfg["physics"]["grid_size"]
    bits = np.unpackbits(packed, axis=-1)[..., : I * I]
    return bits.reshape(*packed.shape[:-1], I, I).astype(np.float32)
