"""Synthetic radio-map simulator (port of ``quantized_spectrum_cartography_tpu/physics``)."""

from quantized_spectrum_cartography_tpu_torch.physics.simulator import (  # noqa: F401
    generate_map,
    generate_map_batch,
    generate_onebit_problem,
    path_loss,
    sample_entry_mask,
)
