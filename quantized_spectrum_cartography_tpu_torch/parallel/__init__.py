from quantized_spectrum_cartography_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_freq_sharding,
    batch_sharding,
    make_mesh,
    replicated,
)
from quantized_spectrum_cartography_tpu_torch.parallel.sharded_solver import (  # noqa: F401
    batched_recover_lowrank,
    make_sharded_mle_step,
    recover_lowrank_mle_ksharded,
)
from quantized_spectrum_cartography_tpu_torch.parallel.scheduler import (  # noqa: F401
    RecoveryScheduler,
)
from quantized_spectrum_cartography_tpu_torch.parallel.multihost import (  # noqa: F401
    GlobalBatch,
    gather_local,
    init_distributed,
    local_batch_to_global,
    make_global_mesh,
    multihost_recover_lowrank,
    process_local_slice,
)
