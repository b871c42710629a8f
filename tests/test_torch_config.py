"""The port's config dataclasses are copies of the JAX package's: same
field names, same defaults."""

import dataclasses

import pytest
import torch

from quantized_spectrum_cartography_tpu import config as jax_config
from quantized_spectrum_cartography_tpu_torch import config as torch_config

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["PhysicsConfig", "QuantizerConfig",
                                  "SolverConfig"])
def test_fields_and_defaults_match(name):
    ref = [(f.name, f.default) for f in
           dataclasses.fields(getattr(jax_config, name))]
    got = [(f.name, f.default) for f in
           dataclasses.fields(getattr(torch_config, name))]
    assert got == ref


def test_quantizer_num_bins():
    bb = (-1.0, 0.0, 1.0, 2.0)
    assert (torch_config.QuantizerConfig(boundaries=bb).num_bins
            == jax_config.QuantizerConfig(boundaries=bb).num_bins == 3)
