"""PyTorch/CUDA port of quantized spectrum cartography.

The port mirrors the module layout of ``quantized_spectrum_cartography_tpu``
(the JAX reference) so that each function's counterpart sits at the same
path.  It imports ``torch`` only.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.

Ported so far: the batched 1-bit low-rank MLE recovery path
(``solvers.lowrank_mle.recover_lowrank_mle``) and the simulator that feeds
it; MLE-GAN recovery (``solvers.mle_gan.recover_mle_gan``) under the
Generator256 or the VAE prior, and DowJons (``solvers.dowjons``); the
completion autoencoders and the VAE; the trained priors read from the JAX
package's orbax checkpoints without orbax (``training.checkpoints``); and
every likelihood kernel of the JAX package, as CUDA C++: the 1-bit pair
(``ops.kernels.onebit_nll``, ``csrc/onebit_nll.cu``) and the ordinal
bounds/coded pairs (``ops.kernels.quantized_nll``, one tile body in
``csrc/ordinal_tile.cuh``); serving and scale-out: the continuous-batching
``parallel.RecoveryScheduler`` over the batched 1-bit solver, the data- and
K-sharded solvers and the multi-process layer under ``torch.distributed``
(``parallel``), and the native C++ queue and shard loader (``runtime``);
the ``.mat`` fixture loader, the deep-image prior, the architecture-dict
builders, the figures and profiling helpers (``utils``), and the
evaluation's condition-grid and miss-probability protocols
(``conditions_grid``, ``missprob``).  With these the port holds a
counterpart of every module of the JAX package.

Layout
------
- ``ops``       quantizer, boundary tables, likelihood, rank-R
                reconstruction, metrics, kernels
- ``physics``   synthetic radio-map simulator
- ``data``      the problem container, the ``.mat`` fixture, the
                simulator-fed training batches
- ``models``    the deep priors: DCGAN generators, autoencoders, the VAE,
                the DIP decoder, the architecture-dict builders
- ``training``  the JAX package's checkpoints (an OCDBT/zarr reader) and
                their parameter trees mapped onto the models
- ``solvers``   recovery loops and the randomized latent search
- ``parallel``  the (data, model) process layout, sharded solvers, the
                multi-process entry and the serving scheduler
- ``runtime``   the native C++ batching queue and shard loader, built with
                g++ at first use into ``build/``
- ``csrc``      hand-written CUDA sources, built at first use into ``build/``
- ``utils``     figures (matplotlib, on the host) and profiling
"""

__version__ = "0.1.0"
