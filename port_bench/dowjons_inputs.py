"""The DowJons cell's inputs and weights, made on the device from the seed.

Maps: a frozen copy of the port's sinc-basis map pipeline
(``physics/psd.py:19-23`` `sinc_bump` and ``:44-74`` `psd_from_draws` for
the separable case; ``physics/simulator.py:45-82`` `generate_map_batch`, in
its order of draws), on `traffic.py`'s frozen shadowing and loss fields.
The observed locations are the first round(f IJ) of a uniform permutation
of the grid per example, drawn as ``baselines/harness.py:make_problem``
draws it.

Weights: the VAE decoder's, drawn at the configuration's widths (He-scaled
kernels, small biases, BatchNorm scales 1 + 0.1 N and shifts 0.1 N, running
statistics those of 256 latent draws through the drawn weights), in
torch's layouts for the reference, and as the flax tree the port's loader
takes (`flax_tree`), the unused encoder and latent heads zero.

Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from port_bench import traffic


# -- physics/psd.py, the sinc basis -----------------------------------------

def sinc_bump(indK, f0, a):
    """sinc((k - f0) / a)^2 on |k - f0| <= a."""
    u = (indK - f0) / a
    return torch.sinc(u).square() * (u.abs() <= 1.0)


def psd_sinc_from_draws(emitter_index, K, amps, widths, centers, first_w):
    """Separable sinc^2 PSDs: the first peak at band 5 + r, the fixed bump
    at band 20."""
    indK = torch.arange(1, K + 1, dtype=torch.float32, device=amps.device)
    num_peaks = widths.shape[-1]

    def col(x):
        return x.unsqueeze(-1)

    c = col(amps[..., 0]) * sinc_bump(indK, col(5.0 + emitter_index),
                                      col(first_w))
    for q in range(num_peaks - 1):
        c = c + col(amps[..., q + 1]) * sinc_bump(
            indK, col(centers[..., q]), col(widths[..., q]))
    return c + col(amps[..., num_peaks]) * sinc_bump(
        indK, 20.0, col(widths[..., num_peaks - 1]))


def generate_sinc_batch(gen, phys: dict, batch: int, chol: torch.Tensor):
    """T [B, K, I, J], S [B, R, I, J], C [B, R, K], peaks [B, R, 2] (x, y)
    of the separable sinc-basis simulator."""
    if phys["psd_basis"] != "s" or not phys["separable"]:
        raise ValueError("this pipeline holds the separable sinc basis only")
    dev = chol.device
    B, R, K = batch, phys["num_emitters"], phys["num_bands"]
    I, Q = phys["grid_size"], phys["num_peaks_per_psd"]

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=dev)

    cand = traffic.candidate_centers(K, Q, dev)
    order = torch.argsort(rand(B, R, cand.shape[0]), dim=-1)
    centers = cand[order[..., : Q - 1]]
    amps = 0.5 + 1.5 * rand(B, R, Q + 1)
    widths = 2.0 + 2.0 * rand(B, R, Q)
    first_w = 2.0 + 3.0 * rand(B, R)
    emitter = torch.arange(R, dtype=torch.float32, device=dev)
    C = traffic.column_normalize(psd_sinc_from_draws(
        emitter, K, amps, widths, centers, first_w))
    loc = (I - 1.0) * rand(B, R, 2)
    alpha = phys["alpha_lo"] + phys["alpha_spread"] * rand(B, R)
    shadow_db = traffic.sample_shadowing(gen, chol, I, phys["shadow_sigma"],
                                         (B, R))
    S = traffic.slf_from_draws(loc, alpha, shadow_db, phys)
    return torch.einsum("brij,brk->bkij", S, C), S, C, loc


def physics(cfg: dict) -> dict:
    """The configuration's physics on the decoder's grid: the maps are drawn
    at the decoder's output size, `prior.output` (51), which fixes it."""
    return dict(cfg["physics"], grid_size=cfg["prior"]["output"])


def example_batches(gen, cfg: dict, examples: int, count: int):
    """`count` batches of `examples` problems: each the maps' draws (T, S,
    C, peaks), the permutation `perm` [B, IJ] whose first round(f IJ)
    entries are the observed locations, and the solver's standard normals
    `draws` (the init fit's start [B, R, z], the restarts' starts [B, n, R,
    z])."""
    ph, pr, sv = physics(cfg), cfg["prior"], cfg["solver"]
    chol = traffic.correlation_cholesky(
        ph["grid_size"], ph["decorrelation_distance"], gen.device)
    R, z, IJ = ph["num_emitters"], pr["latent_dim"], ph["grid_size"] ** 2
    out = []
    for _ in range(count):
        T, S, C, peaks = generate_sinc_batch(gen, ph, examples, chol)
        perm = torch.argsort(torch.rand(examples, IJ, generator=gen,
                                        device=gen.device), dim=-1)
        draws = (torch.randn(examples, R, z, generator=gen,
                             device=gen.device),
                 torch.randn(examples, sv["restarts"], R, z, generator=gen,
                             device=gen.device))
        out.append({"T": T, "S": S, "C": C, "peaks": peaks, "perm": perm,
                    "draws": draws})
    return out


# -- the decoder's weights ----------------------------------------------------

def decoder_weights(gen, prior: dict) -> dict:
    """The decoder's weights in torch's layouts, drawn in one call, with
    BatchNorm running statistics of a batch of 256 latent draws."""
    z, slope = prior["latent_dim"], prior["negative_slope"]
    width = prior["dense"][1]
    spec = [("latent_up.weight", (width, z), math.sqrt(1.0 / z), 0.0),
            ("latent_up.bias", (width,), 0.01, 0.0)]
    for i, (f, k, s, _) in enumerate(prior["stages"]):
        spec += [(f"convt.{i}.weight", (width, f, k, k),
                  math.sqrt(2.0 * s * s / (width * k * k)), 0.0),
                 (f"convt.{i}.bias", (f,), 0.01, 0.0),
                 (f"bn.{i}.weight", (f,), 0.1, 1.0),
                 (f"bn.{i}.bias", (f,), 0.1, 0.0)]
        width = f
    for j, (f, k, _, _) in enumerate(prior["refine"]):
        spec += [(f"conv.{j}.weight", (f, width, k, k),
                  math.sqrt(2.0 / (width * k * k)), 0.0),
                 (f"conv.{j}.bias", (f,), 0.01, 0.0)]
        width = f
    sizes = [math.prod(shape) for _, shape, _, _ in spec]
    flat = torch.randn(sum(sizes), generator=gen, device=gen.device)
    w = {}
    for (name, shape, scale, shift), part in zip(spec, flat.split(sizes)):
        w[name] = part.reshape(shape) * scale + shift
    x = torch.randn(256, z, generator=gen, device=gen.device)
    with torch.no_grad():
        x = (x @ w["latent_up.weight"].T + w["latent_up.bias"])[..., None,
                                                                 None]
        for i, (_, _, s, p) in enumerate(prior["stages"]):
            x = F.conv_transpose2d(x, w[f"convt.{i}.weight"],
                                   w[f"convt.{i}.bias"], s, p)
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            w[f"bn.{i}.running_mean"], w[f"bn.{i}.running_var"] = mean, var
            scale = w[f"bn.{i}.weight"] / torch.sqrt(var + 1e-5)
            x = F.leaky_relu((x - mean[:, None, None]) * scale[:, None, None]
                             + w[f"bn.{i}.bias"][:, None, None], slope)
    return w


def _np(x: torch.Tensor):
    return x.detach().cpu().float().numpy()


def flax_tree(w: dict, prior: dict) -> dict:
    """The VAE's {"params", "batch_stats"} tree in flax's layouts (Conv
    kernels [kh, kw, in, out], ConvTranspose ones spatially flipped, Dense
    kernels [in, out]) from the decoder's torch-layout weights; the encoder
    (`encoder_stages`) and the mean and log-std heads, which decoding never
    runs, are zeros with unit running variances."""
    def bn(features):
        return ({"scale": _np(torch.ones(features)),
                 "bias": _np(torch.zeros(features))},
                {"mean": _np(torch.zeros(features)),
                 "var": _np(torch.ones(features))})

    enc, enc_stats, width = {}, {}, prior["encoder_in"]
    for i, (f, k, _, _) in enumerate(prior["encoder_stages"]):
        enc[f"Conv_{i}"] = {"kernel": _np(torch.zeros(k, k, width, f))}
        if i > 0:
            enc[f"BatchNorm_{i - 1}"], enc_stats[f"BatchNorm_{i - 1}"] = \
                bn(f)
        width = f
    z = prior["latent_dim"]
    heads = {name: {"kernel": _np(torch.zeros(width, z)),
                    "bias": _np(torch.zeros(z))}
             for name in ("mean_head", "logstd_head")}
    dec, dec_stats = {}, {}
    for i in range(len(prior["stages"])):
        dec[f"ConvTranspose_{i}"] = {
            "kernel": _np(w[f"convt.{i}.weight"].permute(2, 3, 0, 1)
                          .flip(0, 1)),
            "bias": _np(w[f"convt.{i}.bias"])}
        dec[f"BatchNorm_{i}"] = {"scale": _np(w[f"bn.{i}.weight"]),
                                 "bias": _np(w[f"bn.{i}.bias"])}
        dec_stats[f"BatchNorm_{i}"] = {"mean": _np(w[f"bn.{i}.running_mean"]),
                                       "var": _np(w[f"bn.{i}.running_var"])}
    for j in range(len(prior["refine"])):
        dec[f"Conv_{j}"] = {"kernel": _np(w[f"conv.{j}.weight"]
                                          .permute(2, 3, 1, 0)),
                            "bias": _np(w[f"conv.{j}.bias"])}
    return {"params": {"encoder": enc, **heads,
                       "latent_up": {"kernel": _np(w["latent_up.weight"].T),
                                     "bias": _np(w["latent_up.bias"])},
                       "decoder": dec},
            "batch_stats": {"encoder": enc_stats, "decoder": dec_stats}}
