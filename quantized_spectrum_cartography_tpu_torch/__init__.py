"""PyTorch/CUDA port of quantized spectrum cartography.

The port mirrors the module layout of ``quantized_spectrum_cartography_tpu``
(the JAX reference) so that each function's counterpart sits at the same
path.  It imports ``torch`` only.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.

Ported so far: the batched 1-bit low-rank MLE recovery path
(``solvers.lowrank_mle.recover_lowrank_mle``), the simulator that feeds it,
and the 1-bit likelihood kernel pair (``ops.kernels.onebit_nll``, CUDA C++
in ``csrc/onebit_nll.cu``).

Layout
------
- ``ops``       quantizer, likelihood, rank-R reconstruction, metrics, kernels
- ``physics``   synthetic radio-map simulator
- ``solvers``   batched recovery loops
- ``csrc``      hand-written CUDA sources, built at first use into ``build/``
"""

__version__ = "0.1.0"
