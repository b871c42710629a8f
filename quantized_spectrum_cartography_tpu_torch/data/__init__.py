"""Problem container and the ``.mat`` fixture loader (port of
``quantized_spectrum_cartography_tpu/data``; the datasets are
``data.datasets``)."""

from quantized_spectrum_cartography_tpu_torch.data.fixtures import (  # noqa: F401
    REFERENCE_FIXTURE,
    Problem,
    load_onebit_fixture,
)
