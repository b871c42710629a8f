"""The port's VAE and completion autoencoders against the flax modules of the
JAX package: on the repository's trained trees read by the port's reader
(checkpoints/vae_best/final, vae_peak_z256, ae_completion/final) and on
small initialized trees of every decoder head, the refinement block and
the autoencoder variants; the VAE prior's glue; MLE-GAN under the trained
VAE decoder; the layers the models share."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_spectrum_cartography_tpu import models as jm
from quantized_spectrum_cartography_tpu.config import (
    QuantizerConfig as JQuant,
    SolverConfig as JSolver,
)
from quantized_spectrum_cartography_tpu.models import layers as jlayers
from quantized_spectrum_cartography_tpu.ops import boundaries as jbnd
from quantized_spectrum_cartography_tpu.ops.quantizer import quantize_log
from quantized_spectrum_cartography_tpu.solvers import (
    recover_mle_gan as jax_recover,
)
from quantized_spectrum_cartography_tpu.solvers import vae_prior as jv
from quantized_spectrum_cartography_tpu_torch import models as tm
from quantized_spectrum_cartography_tpu_torch.config import (
    QuantizerConfig,
    SolverConfig,
)
from quantized_spectrum_cartography_tpu_torch.models import layers as tlayers
from quantized_spectrum_cartography_tpu_torch.solvers import (
    recover_mle_gan,
)
from quantized_spectrum_cartography_tpu_torch.solvers import vae_prior as tv
from quantized_spectrum_cartography_tpu_torch.training import (
    load_checkpoint,
    state_dict_from_flax,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
N = 4


def t(x):
    return torch.tensor(np.array(x))


def nchw(x):
    return t(np.transpose(x, (0, 3, 1, 2)))


def inputs(seed, n=N):
    """(mask, masked map) in flax's NHWC [n, 51, 51, 2]."""
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(size=(n, 51, 51)) < 0.3).astype(np.float32)
    amp = rng.uniform(0.0, 1.0, (n, 51, 51)).astype(np.float32)
    return np.stack([mask, mask * amp], -1)


def port_module(module, tree):
    module.load_state_dict(state_dict_from_flax(tree))   # strict
    return module.eval()


def trained_vae(path):
    """(flax VAE, variables, port VAE) of a trained tree, its architecture
    from the tree's scalar leaves as `load_vae_prior` reads them."""
    state = dict(load_checkpoint(path))
    kw = dict(latent_dim=int(state.pop("latent_dim", 64)),
              beta=float(state.pop("beta", 0.5)),
              head=tv.HEAD_CODES[int(state.pop("head_code", 0))],
              dec_width=int(state.pop("dec_width", 16)),
              refine_width=int(state.pop("refine_width", 0)))
    state.pop("amp", None)
    return jm.VAE(**kw), state, port_module(tm.VAE(**kw), state)


def jitted(module, method=None):
    """module.apply(variables, x) under jit: flax's eager dispatch would
    compile each layer on its own, which takes longer on the CPU."""
    return jax.jit(lambda variables, x: module.apply(variables, x,
                                                     method=method))


def compare_vae(jvae, variables, tvae, seed):
    x = inputs(seed)
    jmean, jlog = jitted(jvae, jm.VAE.encode)(variables, jnp.asarray(x))
    z = np.random.default_rng(seed).standard_normal(
        (N, jvae.latent_dim)).astype(np.float32)
    ref = np.asarray(jitted(jvae, jm.VAE.decode)(variables, jnp.asarray(z)))
    rec = np.asarray(jitted(jvae, jm.VAE.reconstruct)(variables,
                                                      jnp.asarray(x)))
    with torch.no_grad():
        mean, logstd = tvae.encode(nchw(x))
        got = tvae.decode(t(z))
        got_rec = tvae.reconstruct(nchw(x))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), **TOL)
    np.testing.assert_allclose(logstd.numpy(), np.asarray(jlog), **TOL)
    assert got.shape == (N, 1, 51, 51) and ref.shape == (N, 51, 51, 1)
    np.testing.assert_allclose(got.numpy()[:, 0], ref[..., 0], **TOL)
    np.testing.assert_allclose(got_rec.numpy()[:, 0], rec[..., 0], **TOL)


@pytest.mark.parametrize("path", ["checkpoints/vae_best/final",
                                  "checkpoints/vae_peak_z256"])
def test_trained_vae_matches_flax(path):
    """vae_best (sigmoid head, z 128) and vae_peak_z256 (softplus head,
    decoder width 32, refinement block of 16, z 256)."""
    compare_vae(*trained_vae(path), seed=1)


def _randomize_stats(variables, seed):
    """Batch statistics moved off (0, 1), a scaled head's gain off 0, so
    the running statistics and the gain are exercised too."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, variables)

    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "mean":
                node[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
            elif k == "var":
                node[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
            elif k == "log_gain":
                node[k] = np.float32(0.3)

    walk(tree)
    return tree


VAE_CASES = {
    "sigmoid": dict(latent_dim=16),
    "softplus": dict(latent_dim=16, head="softplus"),
    "scaled_sigmoid": dict(latent_dim=16, head="scaled_sigmoid"),
    "softplus_refine": dict(latent_dim=16, head="softplus", refine_width=8),
}


@pytest.mark.parametrize("case", sorted(VAE_CASES))
def test_initialized_vae_matches_flax(case):
    kw = VAE_CASES[case]
    jvae = jm.VAE(**kw)
    variables = _randomize_stats(jax.jit(jvae.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 51, 51, 2)),
        jax.random.PRNGKey(4)), seed=5)
    compare_vae(jvae, variables, port_module(tm.VAE(**kw), variables), 2)


def compare_ae(jae, variables, tae, seed):
    x = inputs(seed)
    h = np.asarray(jitted(jae, jm.Autoencoder.encode)(variables,
                                                      jnp.asarray(x)))
    ref = np.asarray(jitted(jae)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got_h = tae.encode(nchw(x))
        got = tae(nchw(x))
        dec = tae.decode(t(h))
    np.testing.assert_allclose(got_h.numpy(), h, **TOL)
    np.testing.assert_allclose(got.numpy()[:, 0], ref[..., 0], **TOL)
    np.testing.assert_allclose(dec.numpy()[:, 0], ref[..., 0], **TOL)


def test_trained_autoencoder_matches_flax():
    """ae_completion (SELU, the activation it was trained with)."""
    state = dict(load_checkpoint("checkpoints/ae_completion/final"))
    state.pop("scale")
    compare_ae(jm.Autoencoder(), state, port_module(tm.Autoencoder(), state),
               seed=3)


AE_CASES = {
    "selu": (lambda m: m.Autoencoder()),
    "leaky_relu": (lambda m: m.Autoencoder(activation="leaky_relu")),
    "linear_bottleneck": (lambda m: m.AutoencoderLinear(32)),
    "encoder_decoder_128": (lambda m: m.EncoderDecoder(128)),
}


@pytest.mark.parametrize("case", sorted(AE_CASES))
def test_initialized_autoencoders_match_flax(case):
    jae = AE_CASES[case](jm)
    variables = _randomize_stats(jax.jit(jae.init)(
        jax.random.PRNGKey(6), jnp.zeros((1, 51, 51, 2))), 7)
    compare_ae(jae, variables, port_module(AE_CASES[case](tm), variables), 4)


def test_vae_loss_and_reparameterize():
    rng = np.random.default_rng(8)
    recon = rng.uniform(0.0, 1.0, (N, 51, 51, 1)).astype(np.float32)
    target = rng.uniform(0.0, 1.0, (N, 51, 51, 1)).astype(np.float32)
    mean = rng.normal(size=(N, 16)).astype(np.float32)
    logstd = rng.normal(0.0, 0.3, (N, 16)).astype(np.float32)
    ref = jm.VAE(latent_dim=16, beta=0.5).loss(
        jnp.asarray(recon), jnp.asarray(target), jnp.asarray(mean),
        jnp.asarray(logstd))
    got = tm.VAE(latent_dim=16, beta=0.5).loss(
        nchw(recon), nchw(target), t(mean), t(logstd))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-5)
    gen = torch.Generator().manual_seed(0)
    z = tm.VAE.reparameterize(t(mean), t(logstd), gen)
    eps = torch.randn(mean.shape, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(z, t(mean) + torch.exp(t(logstd)) * eps)
    draws = tm.VAE(latent_dim=16).eval().sample(3, gen)
    assert draws.shape == (3, 1, 51, 51)


def test_load_vae_prior_and_generator_match():
    """load_vae_prior / make_vae_generator: G(Z) at SLF amplitude."""
    jgen, jlat, jstate = jv.load_vae_prior("checkpoints/vae_best/final")
    tgen, tlat, tstate = tv.load_vae_prior("checkpoints/vae_best/final",
                                           device="cpu")
    assert tlat == jlat == 128 and sorted(tstate) == sorted(jstate)
    assert tv.DEFAULT_AMP == jv.DEFAULT_AMP
    assert tv.HEAD_CODES == jv.HEAD_CODES
    Z = np.random.default_rng(9).standard_normal((N, jlat)).astype(
        np.float32)
    with torch.no_grad():
        got = tgen(t(Z))
        half = tv.make_vae_generator(tstate, tlat, amp=0.5)(t(Z))
    ref = np.asarray(jax.jit(jgen)(jnp.asarray(Z)))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_allclose(half.numpy(), ref * (0.5 / tv.DEFAULT_AMP),
                               **TOL)


@pytest.mark.parametrize("ndim", [2, 3])
def test_encoder_init_matches(ndim):
    """The encoder's mean of (mask, masked map / amp), for one observed
    map [I, J] or one per emitter [R, I, J]."""
    tree = load_checkpoint("checkpoints/vae_best/final")
    latent = int(tree["latent_dim"])
    state = {k: tree[k] for k in ("params", "batch_stats")}
    rng = np.random.default_rng(10)
    mask = (rng.uniform(size=(51, 51)) < 0.2).astype(np.float32)
    obs = rng.uniform(0.0, 0.3, (2, 51, 51)[3 - ndim:]).astype(np.float32)
    ref = jv.encoder_init(state, jnp.asarray(mask), jnp.asarray(obs), latent)
    got = tv.encoder_init(state, t(mask), t(obs), latent)
    assert got.shape == ref.shape == (2 if ndim == 3 else 1, latent)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# --- MLE-GAN under the trained VAE decoder --------------------------------

K, R = 8, 2
QUANT = dict(boundaries=jbnd.QUANTIZATION_BOUNDARIES_4_BINS_LOG,
             noise_std=5.0, domain="log", log_offset=jbnd.LOG_OFFSET_4)
SOLVER = dict(max_iters=6, z_search_global=8, z_search_local=8,
              z_search_at_iter=1, z_dim=128)
KEY = jax.random.PRNGKey(1)


def test_mle_gan_under_trained_vae_matches_jax():
    """recover_mle_gan with G the trained vae_best decoder, on a problem
    the decoder realizes (K=8), with the JAX run's Z_init and search draws
    injected: costs, NMSEs, C and Z within rtol 1e-3 (atol 1e-6 of each
    array's largest entry), as tests/test_torch_mle_gan.py holds the
    Generator256 path."""
    jgen, _, _ = jv.load_vae_prior("checkpoints/vae_best/final")
    tgen, _, _ = tv.load_vae_prior("checkpoints/vae_best/final",
                                   device="cpu")
    kz, kc, kq, km = jax.random.split(jax.random.PRNGKey(7), 4)
    T_true = jnp.einsum("rij,rk->kij", jgen(jax.random.normal(kz, (R, 128))),
                        jnp.abs(jax.random.normal(kc, (R, K))))
    Y = quantize_log(kq, T_true, QUANT["noise_std"],
                     jnp.asarray(np.array(QUANT["boundaries"])),
                     QUANT["log_offset"])
    mask = jax.random.bernoulli(km, 0.3, Y.shape).astype(jnp.float32)
    ref = jax_recover(KEY, Y, mask, jgen, JSolver(**SOLVER), JQuant(**QUANT),
                      num_emitters=R, T_true=T_true)
    key, kz = jax.random.split(KEY)
    _, ks = jax.random.split(key)
    k1, k2 = jax.random.split(ks)
    draws = (t(jax.random.normal(k1, (8, R, 128))),
             t(jax.random.normal(k2, (8, R, 128))))
    port = recover_mle_gan(t(Y), t(mask), tgen, SolverConfig(**SOLVER),
                           QuantizerConfig(**QUANT),
                           Z_init=t(jax.random.normal(kz, (R, 128))),
                           num_emitters=R, T_true=t(T_true),
                           search_draws=draws)
    for name, a, b in (("costs", port.costs, ref.costs),
                       ("nmses", port.nmses, ref.nmses),
                       ("C", port.C, ref.C),
                       ("Z", port.aux["Z"], ref.aux["Z"])):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=1e-3,
                                   atol=1e-6 * np.abs(b).max(), err_msg=name)


# --- shared layers --------------------------------------------------------

def test_upsample_and_total_variation_match():
    x = np.random.default_rng(11).normal(size=(2, 7, 9, 3)).astype(
        np.float32)
    up = tlayers.upsample2x(nchw(x))
    np.testing.assert_array_equal(
        up.numpy(), np.transpose(np.asarray(
            jlayers.upsample2x(jnp.asarray(x))), (0, 3, 1, 2)))
    np.testing.assert_allclose(
        tlayers.total_variation_loss(nchw(x)).item(),
        float(jlayers.total_variation_loss(jnp.asarray(x))), rtol=1e-6)


def test_batch_norm_matches_flax_in_both_modes():
    """Training mode: normalized by the batch, running statistics moved
    by flax's momentum 0.9 (torch's 0.1) with the biased batch variance,
    as flax moves them (torch's own BatchNorm2d takes the unbiased one);
    inference: the running statistics."""
    x = np.random.default_rng(12).normal(1.0, 2.0, (8, 5, 5, 3)).astype(
        np.float32)
    jbn = jlayers.BatchNorm()
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    ref, upd = jbn.apply(variables, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    tbn = tlayers.BatchNorm(3).train()
    got = tbn(nchw(x))
    np.testing.assert_allclose(got.detach().numpy(),
                               np.transpose(np.asarray(ref), (0, 3, 1, 2)),
                               **TOL)
    stats = upd["batch_stats"]["BatchNorm_0"]
    n = x.shape[0] * x.shape[1] * x.shape[2]
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(stats["mean"]), **TOL)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(stats["var"]), **TOL)
    np.testing.assert_allclose(
        tbn.running_var.numpy(),
        0.9 + 0.1 * x.reshape(-1, 3).var(0, ddof=0), **TOL)
    np.testing.assert_allclose(
        np.asarray(stats["var"]),
        0.9 + 0.1 * x.reshape(-1, 3).var(0) * n / n, **TOL)
    ref_eval = jbn.apply(variables, jnp.asarray(x), train=False)
    got_eval = tlayers.BatchNorm(3).eval()(nchw(x))
    np.testing.assert_allclose(got_eval.detach().numpy(),
                               np.transpose(np.asarray(ref_eval),
                                            (0, 3, 1, 2)), **TOL)
