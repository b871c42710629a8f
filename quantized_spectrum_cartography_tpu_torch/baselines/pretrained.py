"""The five published methods from the committed checkpoints.

Port of ``quantized_spectrum_cartography_tpu/baselines/pretrained.py``
(`backup/algorithms/joint_opt_ae.m:570-655`): TPS and BTD need no trained
model; DeepComp and Nasdac use the completion autoencoder
(`checkpoints/ae_completion/final`); DowJons uses the VAE prior
(`checkpoints/vae_peak_z256`, the softplus-head z256 VAE).  The checkpoint
paths resolve from this package's location, not the working directory.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

REPO_ROOT = Path(__file__).resolve().parents[2]
AE_CKPT = str(REPO_ROOT / "checkpoints" / "ae_completion" / "final")
VAE_CKPT = str(REPO_ROOT / "checkpoints" / "vae_peak_z256")


def load_pretrained_methods(
    ae_ckpt: str = AE_CKPT,
    vae_ckpt: str = VAE_CKPT,
    only: Optional[tuple] = None,
    device: str = "cuda",
    **standard_kwargs,
) -> Dict:
    """`standard_methods` with the committed AE completer and VAE prior on
    `device`.  `only` restricts the registry; a name it does not hold
    raises (the selected dowjons variant is registered as 'dowjons')."""
    from quantized_spectrum_cartography_tpu_torch.baselines.harness import (
        standard_methods)
    from quantized_spectrum_cartography_tpu_torch.solvers.vae_prior import (
        load_vae_prior)
    from quantized_spectrum_cartography_tpu_torch.training.ae_trainer import (
        load_ae, make_ae_completer, make_ae_latent_fns)

    ae_model, scale = load_ae(ae_ckpt, "selu", device)
    gen, z_dim, _ = load_vae_prior(vae_ckpt, device=device)
    methods = standard_methods(gen_apply=gen, z_dim=z_dim,
                               ae_complete=make_ae_completer(ae_model, scale),
                               ae_latent_fns=make_ae_latent_fns(ae_model,
                                                                scale),
                               **standard_kwargs)
    if only is not None:
        unknown = [m for m in only if m not in methods]
        if unknown:
            raise KeyError(
                f"unknown method(s) {unknown}; registered: "
                f"{sorted(methods)} (note: the selected dowjons variant "
                f"is registered under the canonical name 'dowjons')")
        methods = {k: v for k, v in methods.items() if k in only}
    return methods
