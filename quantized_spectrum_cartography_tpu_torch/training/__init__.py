"""Weights of the deep priors (port of ``quantized_spectrum_cartography_tpu/training``)."""

from quantized_spectrum_cartography_tpu_torch.training.checkpoints import (  # noqa: F401
    generator_state_dict_from_flax,
    latest_step_dir,
    load_checkpoint,
    load_generator,
    load_npz_tree,
    state_dict_from_flax,
)
