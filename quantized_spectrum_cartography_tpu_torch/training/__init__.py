"""Weights and training of the deep priors (port of
``quantized_spectrum_cartography_tpu/training``)."""

from quantized_spectrum_cartography_tpu_torch.training.checkpoints import (  # noqa: F401
    flax_from_state_dict,
    generator_state_dict_from_flax,
    latest_step_dir,
    load_checkpoint,
    load_generator,
    load_npz_tree,
    save_checkpoint,
    state_dict_from_flax,
)
from quantized_spectrum_cartography_tpu_torch.training.gan_trainer import (  # noqa: F401
    GANTrainConfig,
    train_gan,
)
from quantized_spectrum_cartography_tpu_torch.training.ae_trainer import (  # noqa: F401
    AETrainConfig,
    load_ae,
    make_ae_completer,
    train_ae,
)
from quantized_spectrum_cartography_tpu_torch.training.vae_trainer import (  # noqa: F401
    VAETrainConfig,
    heldout_elbo,
    train_vae,
)
