"""Recovery loops (port of ``quantized_spectrum_cartography_tpu/solvers``)."""

from quantized_spectrum_cartography_tpu_torch.solvers.base import (  # noqa: F401
    RecoveryResult,
)
from quantized_spectrum_cartography_tpu_torch.solvers.dip_solver import (  # noqa: F401
    recover_dip,
    recover_dip_tensor,
)
from quantized_spectrum_cartography_tpu_torch.solvers.dowjons import (  # noqa: F401
    recover_dowjons,
)
from quantized_spectrum_cartography_tpu_torch.solvers.gan_inversion import (  # noqa: F401
    init_z,
    run_onebit_inversion,
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
from quantized_spectrum_cartography_tpu_torch.solvers.completion import (  # noqa: F401
    optimize_z,
    recover_dowjons_ae,
    recover_dowjons_ae_latent,
    recover_dowjons_unquantized,
    recover_masked_mse,
    run_descent_ae,
)
from quantized_spectrum_cartography_tpu_torch.solvers.nasdac import (  # noqa: F401
    recover_nasdac,
)
from quantized_spectrum_cartography_tpu_torch.solvers.calibrate import (  # noqa: F401
    recalibrate_gain,
)
