"""The chip's peaks and the work of each unit (a solve, a map) counted from
its shapes: the yardstick of the roofline and MFU metrics.

Peaks: NVIDIA's data sheet for one H100 SXM at 700 W: 3.35 TB/s of HBM and
67 TFLOP/s of float32 outside the tensor cores (every cell runs with TF32
off).  A card set below 700 W (`power_limit_w` in the result) reaches less.

The likelihood kernels' bytes and operations are frozen copies of
``chip_smoke.py:2092-2183`` (`bound`, `timing_onebit`, `timing_ordinal`):
each input read once and each output written once, the f32 operations of
the TPU kernels' cost estimates, over the entries a launch observes.
"""

from __future__ import annotations

from typing import Sequence, Tuple

PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12


def least_s(nbytes: float, flops: float) -> float:
    """The least time the chip could take: bytes or operations, whichever
    bounds it."""
    return max(nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S)


# -- the 1-bit pair (csrc/onebit_nll.cu) ------------------------------------

def onebit_fwd(B, R, K, P) -> Tuple[float, float]:
    """(bytes, flops) of one forward launch over B maps: int8 codes,
    S [B, R, P] and C [B, K, R] in, one f32 per map out."""
    return (B * K * P + 4 * B * (R * P + K * R) + 4 * B,
            B * (2 * K * R * P + 17 * K * P))


def onebit_bwd(B, R, K, P) -> Tuple[float, float]:
    """The backward: codes, S, C and g in; dS and dC out."""
    return (B * K * P + 8 * B * (R * P + K * R) + 4 * B,
            B * (6 * K * R * P + 23 * K * P))


# -- the ordinal pair on f32 bounds (csrc/quantized_nll.cu) -----------------

def bounds_fwd(N, R, K, P, observed, shared_obs=False) -> Tuple[float, float]:
    """N maps or candidates; W, U 8 B an entry, read once (once in all
    when the N candidates share them and C); `observed` entries of each."""
    obs = 1 if shared_obs else N
    c = 1 if shared_obs else N
    return (4 * (N * R * P + c * K * R) + 8 * obs * K * P + 4 * N,
            N * observed * (2 * R + 25 + 4))


def bounds_bwd(N, R, K, P, observed) -> Tuple[float, float]:
    return (8 * N * (R * P + K * R) + 8 * N * K * P + 4 * N,
            N * observed * (6 * R + 30 + 5))


# -- the prior's convolutions ------------------------------------------------

def generator_flops(z_dim: int, stages: Sequence[Sequence[int]],
                    final_conv: Sequence[int]) -> float:
    """Multiply-adds x 2 of one sample's forward through the DCGAN stage
    table (ConvTranspose per stage, then the final convolution); the data
    gradient costs the same again."""
    flops, width, size = 0.0, z_dim, 1
    for features, k, s, p in stages:
        flops += 2.0 * width * features * k * k * size * size
        size = (size - 1) * s - 2 * p + k
        width = features
    features, k, s, p = final_conv
    out = (size + 2 * p - k) // s + 1
    return flops + 2.0 * width * features * k * k * out * out


# -- whole units --------------------------------------------------------------

def lowrank_solve(cfg: dict, B: int) -> dict:
    """A batched low-rank solve of B maps: its likelihood launches' least
    time and its f32 operations (likelihood passes, Adam, projection)."""
    ph, sv = cfg["physics"], cfg["solver"]
    R, K = ph["num_emitters"], ph["num_bands"]
    I = ph["grid_size"]
    P = I * I
    steps = sv["max_iters"] * (sv["s_inner_iters"] + sv["c_inner_iters"])
    fb, ff = onebit_fwd(B, R, K, P)
    bb, bf = onebit_bwd(B, R, K, P)
    least = steps * (least_s(fb, ff) + least_s(bb, bf))
    # Adam: about 12 operations an element of the factor it steps
    adam = 12.0 * B * (sv["max_iters"] * sv["s_inner_iters"] * R * P
                       + sv["max_iters"] * sv["c_inner_iters"] * R * K)
    k = sv["rank_truncation"] + sv["oversample"]
    r = sv["rank_truncation"]
    m = n = I
    proj = (3 * 2 * m * n * k            # S G0, S (S^T Q)
            + 2 * (2 * m * k * k - 2 * k ** 3 / 3)   # two QRs
            + 2 * k * m * n + 2 * k * k * n + 9 * k ** 3   # B, B B^T, eigh
            + 2 * m * k * r + 2 * 2 * r * m * n)     # U, U (U^T S)
    projections = sv["max_iters"] // sv["projection_interval"]
    flops = steps * (ff + bf) + adam + projections * B * R * proj
    return {"likelihood_least_s": least, "flops": flops}


def mlegan_map(cfg: dict, observed: int) -> dict:
    """One MLE-GAN map: the bounds pair at B=1 each C and Z step, the
    scorer over each search phase's candidates, the generator's forwards
    and data gradients."""
    ph, sv, pr = cfg["physics"], cfg["solver"], cfg["prior"]
    R, K = ph["num_emitters"], ph["num_bands"]
    P = ph["grid_size"] ** 2
    iters = sv["max_iters"]
    steps = iters * (sv["c_inner_iters"] + sv["s_inner_iters"])
    ff_b, ff_f = bounds_fwd(1, R, K, P, observed)
    bw_b, bw_f = bounds_bwd(1, R, K, P, observed)
    least = steps * (least_s(ff_b, ff_f) + least_s(bw_b, bw_f))
    flops = steps * (ff_f + bw_f)
    for n in (sv["z_search_global"] + 1, sv["z_search_local"] + 1):
        sb, sf = bounds_fwd(n, R, K, P, observed, shared_obs=True)
        least += least_s(sb, sf)
        flops += sf
    g = generator_flops(pr["z_dim"], pr["stages"], pr["final_conv"])
    # each Z step: forward and data gradient of the cost, then S = G(Z);
    # one forward before the loop; the search's candidates
    samples = (R * (iters * sv["s_inner_iters"] * 2 + iters + 1)
               + R * (sv["z_search_global"] + sv["z_search_local"] + 2))
    flops += samples * g
    return {"likelihood_least_s": least, "flops": flops}
