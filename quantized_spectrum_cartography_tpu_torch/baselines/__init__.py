"""The published-SRE baselines and the evaluation harness (port of
``quantized_spectrum_cartography_tpu/baselines``)."""

from quantized_spectrum_cartography_tpu_torch.baselines.spa import (  # noqa: F401
    column_sum_normalize,
    nmf_spa,
    spa_indices,
)
from quantized_spectrum_cartography_tpu_torch.baselines.nnls import (  # noqa: F401
    nnls,
    nnls_rows,
)
from quantized_spectrum_cartography_tpu_torch.baselines.tps import (  # noqa: F401
    tps_complete,
)
from quantized_spectrum_cartography_tpu_torch.baselines.harness import (  # noqa: F401
    BatchedHarness,
    Condition,
    HarnessProblem,
    REFERENCE_AXES,
    best_permutation,
    condition_grid,
    evaluate_method,
    make_problem,
    run_conditions,
    run_conditions_batched,
    run_sweep,
    standard_methods,
)
from quantized_spectrum_cartography_tpu_torch.baselines.btd import (  # noqa: F401
    btd_ll1,
)
from quantized_spectrum_cartography_tpu_torch.baselines.pretrained import (  # noqa: F401
    load_pretrained_methods,
)
