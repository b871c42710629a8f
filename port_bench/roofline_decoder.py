"""The work of a DowJons call under the VAE decoder, counted from shapes: the
yardstick of `decoder_roofline_pct.dowjons` and `step_mfu_pct.dowjons`.

Each convolution and transposed convolution of the decoder is counted per
launch: 2 x multiply-adds f32 operations, and its input, weights and output
read or written once (4 B an element); the data gradient of a layer moves
the same bytes and does the same operations.  Peaks and `least_s` are
`roofline.py`'s (one H100 SXM at 700 W, TF32 off).
"""

from __future__ import annotations

from typing import List, Tuple

from port_bench.roofline import least_s

Layer = Tuple[int, int, int, int, int]   # in, out, kernel, in px, out px


def conv_layers(prior: dict) -> List[Layer]:
    """(in channels, out channels, kernel, input side, output side) of each
    convolution of the decoder, transposed ones first."""
    out, width, size = [], prior["dense"][1], 1
    for f, k, s, p in prior["stages"]:
        new = (size - 1) * s - 2 * p + k
        out.append((width, f, k, size, new))
        width, size = f, new
    for f, k, s, p in prior["refine"]:
        new = (size + 2 * p - k) // s + 1
        out.append((width, f, k, size, new))
        width, size = f, new
    return out


def layer_macs(layer: Layer) -> int:
    """Multiply-adds of one sample through a layer: a transposed
    convolution scatters each input pixel through the whole kernel, a
    convolution gathers the kernel at each output pixel; either way in x
    out x k^2 x (the pixels the kernel is applied at)."""
    cin, cout, k, side_in, side_out = layer
    grows = side_out > side_in
    return cin * cout * k * k * (side_in if grows else side_out) ** 2


def decoder_macs(prior: dict) -> int:
    """Multiply-adds of one sample's forward: the Dense layer and every
    convolution."""
    z, width = prior["dense"]
    return z * width + sum(layer_macs(x) for x in conv_layers(prior))


def conv_least_s(prior: dict, n: int) -> float:
    """The least time of one forward (or one data gradient) of the
    decoder's convolutions over n samples."""
    total = 0.0
    for layer in conv_layers(prior):
        cin, cout, k, side_in, side_out = layer
        nbytes = 4.0 * (n * cin * side_in ** 2 + cin * cout * k * k
                        + n * cout * side_out ** 2)
        total += least_s(nbytes, 2.0 * n * layer_macs(layer))
    return total


def dowjons_call(cfg: dict, examples: int) -> dict:
    """One call of B = `examples` problems: the decoder's convolutions'
    least time, and the f32 operations of the decoder's passes (forward
    and data gradient of every z-step and init step, forward of every
    C-step and of the winner's choice) with the residual's reconstruction
    and Adam on the latents."""
    ph, pr, sv = cfg["physics"], cfg["prior"], cfg["solver"]
    R, K, P = ph["num_emitters"], ph["num_bands"], pr["output"] ** 2
    n = examples * sv["restarts"] * R               # latents of a z-step
    m = examples * R                                # latents of the init fit
    z_steps = sv["max_iters"] * sv["s_inner_iters"]
    forwards = sv["max_iters"] + 2                  # C-steps, the pick
    g = 2.0 * decoder_macs(pr)
    flops = g * (2 * (z_steps * n + sv["init_steps"] * m) + forwards * n)
    # the masked residual: T_hat = S C (2 R ops an entry) and its square,
    # forward and back, per restart; Adam about 12 ops a latent entry
    entries = examples * sv["restarts"] * K * P
    flops += z_steps * (3 * (2 * R + 3) * entries + 12 * n * pr["latent_dim"])
    least = (2 * (z_steps * conv_least_s(pr, n)
                  + sv["init_steps"] * conv_least_s(pr, m))
             + forwards * conv_least_s(pr, n))
    return {"conv_least_s": least, "flops": flops}
