"""Recovery loops (port of ``quantized_spectrum_cartography_tpu/solvers``)."""

from quantized_spectrum_cartography_tpu_torch.solvers.base import (  # noqa: F401
    RecoveryResult,
)
from quantized_spectrum_cartography_tpu_torch.solvers.dowjons import (  # noqa: F401
    recover_dowjons,
)
from quantized_spectrum_cartography_tpu_torch.solvers.lowrank_mle import (  # noqa: F401
    SolverState,
    from_jax_state,
    recover_lowrank_mle,
    to_jax_state,
)
from quantized_spectrum_cartography_tpu_torch.solvers.mle_gan import (  # noqa: F401
    GanSolverState,
    recover_mle_gan,
)
from quantized_spectrum_cartography_tpu_torch.solvers.priors import (  # noqa: F401
    make_generator_apply,
    randomized_search,
)
from quantized_spectrum_cartography_tpu_torch.solvers.vae_prior import (  # noqa: F401
    encoder_init,
    load_vae_prior,
    make_vae_generator,
)
