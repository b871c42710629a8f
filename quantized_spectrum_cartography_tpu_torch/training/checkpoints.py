"""Generator weights from the JAX package's parameters, without orbax.

The JAX package keeps its priors as orbax checkpoints (`checkpoints/`), which
only orbax and tensorstore read.  Here the same parameter tree, as a nested
dict of numpy arrays (what ``training/checkpoints.py:load_checkpoint`` of the
JAX package returns, or an ``.npz`` written from it with "/"-joined keys),
becomes a `DCGANGenerator` state_dict:

- flax ``ConvTranspose`` kernels [kh, kw, in, out] become torch's
  [in, out, kh, kw], flipped in both spatial axes: flax applies the kernel
  unflipped to the dilated input, torch's transpose convolution flips it;
- ``Conv`` kernels [kh, kw, in, out] become [out, in, kh, kw], unflipped;
- ``Dense`` kernels [in, out] become Linear weights [out, in];
- BatchNorm ``scale``/``bias`` and ``batch_stats`` ``mean``/``var`` become
  ``weight``/``bias``/``running_mean``/``running_var``;
- ``scale``, where the tree has one, is the output divisor that the CLI
  applies to the generator (JAX ``cli.py:_load_prior``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from quantized_spectrum_cartography_tpu_torch.models.generator import (
    DCGANGenerator,
    make_generator,
)


def load_npz_tree(path: str) -> Dict[str, Any]:
    """Nested dict of numpy arrays from an ``.npz`` whose keys are the tree's
    "/"-joined paths (e.g. ``params/ConvTranspose_0/kernel``)."""
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = tree
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = data[key]
    return tree


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def generator_state_dict_from_flax(
    tree: Dict[str, Any],
) -> Tuple[Dict[str, torch.Tensor], float]:
    """(state_dict of `DCGANGenerator`, output scale) from a flax generator's
    {"params": ..., "batch_stats": ..., ["scale"]} tree."""
    params, stats = tree["params"], tree["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    if "Dense_0" in params:
        sd["stem.weight"] = _t(params["Dense_0"]["kernel"]).T.contiguous()
        sd["stem.bias"] = _t(params["Dense_0"]["bias"])
    n = sum(1 for name in params if name.startswith("ConvTranspose_"))
    for i in range(n):
        ct = params[f"ConvTranspose_{i}"]
        sd[f"convt.{i}.weight"] = (_t(ct["kernel"]).flip(0, 1)
                                   .permute(2, 3, 0, 1).contiguous())
        sd[f"convt.{i}.bias"] = _t(ct["bias"])
        bn, st = params[f"BatchNorm_{i}"], stats[f"BatchNorm_{i}"]
        sd[f"bn.{i}.weight"] = _t(bn["scale"])
        sd[f"bn.{i}.bias"] = _t(bn["bias"])
        sd[f"bn.{i}.running_mean"] = _t(st["mean"])
        sd[f"bn.{i}.running_var"] = _t(st["var"])
        sd[f"bn.{i}.num_batches_tracked"] = torch.tensor(0)
    sd["conv.weight"] = (_t(params["Conv_0"]["kernel"])
                         .permute(3, 2, 0, 1).contiguous())
    sd["conv.bias"] = _t(params["Conv_0"]["bias"])
    scale = float(np.asarray(tree["scale"])) if "scale" in tree else 1.0
    return sd, scale


def load_generator(tree: Dict[str, Any], z_dim: int = 256,
                   device: Optional[str] = None
                   ) -> Tuple[DCGANGenerator, float]:
    """(generator in eval mode with the tree's weights, output scale)."""
    sd, scale = generator_state_dict_from_flax(tree)
    gen = make_generator(z_dim)
    gen.load_state_dict(sd)
    return gen.to(device).eval(), scale
