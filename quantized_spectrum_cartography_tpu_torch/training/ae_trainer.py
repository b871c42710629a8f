"""The completion autoencoder as the harness uses it (the Nasdac / DeepComp
prior and the DowJons-AE S-steps).

Port of the closures of ``quantized_spectrum_cartography_tpu/training/
ae_trainer.py`` (`make_ae_completer`, `make_ae_latent_fns`,
`make_ae_input_fn`) on the port's NCHW `Autoencoder`; the closures keep the
JAX functions' layouts ([..., I, J] maps, the network input as
[..., I, J, 2]) and convert at the model call.  Leading axes are batch axes,
run through the network in chunks of `chunk` maps.  `train_ae` is not
ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from quantized_spectrum_cartography_tpu_torch.models import Autoencoder
from quantized_spectrum_cartography_tpu_torch.training.checkpoints import (
    load_checkpoint,
    state_dict_from_flax,
)

CHUNK = 4096


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
