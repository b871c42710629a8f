"""Deep-prior networks (port of ``quantized_spectrum_cartography_tpu/models``)."""

from quantized_spectrum_cartography_tpu_torch.models.dip import (  # noqa: F401
    DecoderDip,
)
from quantized_spectrum_cartography_tpu_torch.models.builders import (  # noqa: F401
    DictDiscriminator,
    DictEncoder,
    GANEncoder,
    InvalidArchitectureError,
)
from quantized_spectrum_cartography_tpu_torch.models.ae import (  # noqa: F401
    Autoencoder,
    AutoencoderLinear,
    Decoder,
    Encoder,
    EncoderDecoder,
)
from quantized_spectrum_cartography_tpu_torch.models.generator import (  # noqa: F401
    DCGANGenerator,
    Generator64,
    Generator128,
    Generator256,
    Generator512,
    make_generator,
)
from quantized_spectrum_cartography_tpu_torch.models.discriminator import (  # noqa: F401
    Discriminator,
    SNDiscriminator,
)
from quantized_spectrum_cartography_tpu_torch.models.vae import (  # noqa: F401
    VAE,
    betaVAE,
)
from quantized_spectrum_cartography_tpu_torch.models.layers import (  # noqa: F401
    total_variation_loss,
)
from quantized_spectrum_cartography_tpu_torch.models.aae import (  # noqa: F401
    AAEDecoder,
    AAEEncoder,
    LatentDiscriminator,
)
