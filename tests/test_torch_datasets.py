"""The port's simulator-fed training batches against the JAX package's
``data/datasets.py`` on JAX's own random numbers (passed as ``draws=``):
the SLF sampler, the masks (raw, 1-bit, peak-normalized), the GAN sample
batch and the boundaries from simulator samples; then the port's own draws
by their statistics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_support import mask_draws, slf_draws, t

from quantized_spectrum_cartography_tpu.config import PhysicsConfig as JPhys
from quantized_spectrum_cartography_tpu.data import datasets as jd
from quantized_spectrum_cartography_tpu_torch.config import PhysicsConfig
from quantized_spectrum_cartography_tpu_torch.data import datasets as td

torch.set_num_threads(1)

# float32 assembly of the same numbers: the shadowing is a 2601-term dot
# product (its order differs), exponentiated through 10^(dB/10)
TOL = dict(rtol=1e-4, atol=1e-7)
PHYS = dict(decorrelation_distance=30.0)


@pytest.mark.parametrize("kw", [{}, PHYS], ids=["default", "xc30"])
def test_slf_sampler_matches_jax_on_its_draws(kw):
    key = jax.random.PRNGKey(0)
    ref = np.asarray(jd.make_slf_sampler(JPhys(**kw))(key, 5))
    got = td.make_slf_sampler(PhysicsConfig(**kw), "cpu")(
        None, 5, slf_draws(key, 5))
    assert got.shape == (5, 51, 51)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


MASK_CASES = {
    "plain": dict(batch_size=3),
    "onebit": dict(batch_size=3, onebit=True, mean_slf=0.005),
    "normalize_peak": dict(batch_size=3, normalize_peak=True),
    "narrow_rates": dict(batch_size=3, sample_lo=0.3, sample_hi=0.4),
}


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_mask_batch_matches_jax(case):
    """The same maps and uniforms: the same masks bit for bit, inputs and
    targets NCHW instead of NHWC."""
    cfg = MASK_CASES[case]
    maps = np.asarray(jax.random.uniform(jax.random.PRNGKey(1),
                                         (3, 51, 51))) * 0.01
    key = jax.random.PRNGKey(2)
    inp, target = jd.mask_batch(key, jnp.asarray(maps),
                                jd.SLFBatchConfig(**cfg))
    got_inp, got_target = td.mask_batch(None, t(maps),
                                        td.SLFBatchConfig(**cfg),
                                        mask_draws(key, maps.shape))
    assert got_inp.shape == (3, 2, 51, 51)
    assert got_target.shape == (3, 1, 51, 51)
    inp = np.transpose(np.asarray(inp), (0, 3, 1, 2))
    assert np.array_equal(got_inp[:, 0].numpy(), inp[:, 0])
    np.testing.assert_allclose(got_inp.numpy(), inp, rtol=1e-6)
    np.testing.assert_allclose(got_target.numpy(),
                               np.transpose(np.asarray(target), (0, 3, 1, 2)),
                               rtol=1e-6)


def test_slf_batches_match_jax():
    """Two batches of JAX's iterator (a key split into three per batch)
    from their draws."""
    key = jax.random.PRNGKey(6)
    cfg = dict(batch_size=2, onebit=True)
    it = jd.slf_batches(key, jd.SLFBatchConfig(**cfg), JPhys(**PHYS))
    draws = []
    for _ in range(2):
        key, k1, k2 = jax.random.split(key, 3)
        draws.append((slf_draws(k1, 2), mask_draws(k2, (2, 51, 51))))
    got = list(td.slf_batches(None, td.SLFBatchConfig(**cfg),
                              PhysicsConfig(**PHYS), draws))
    assert len(got) == 2
    for (inp, target), (g_inp, g_target) in zip(it, got):
        np.testing.assert_array_equal(
            g_inp.numpy(), np.transpose(np.asarray(inp), (0, 3, 1, 2)))
        np.testing.assert_allclose(g_target[:, 0].numpy(),
                                   np.asarray(target)[..., 0], **TOL)


def test_gan_sample_batch_matches_jax():
    key = jax.random.PRNGKey(3)
    w = np.random.default_rng(0).normal(size=(16,)).astype(np.float32)
    s, z = jd.gan_sample_batch(key, lambda z: z @ jnp.asarray(w), 5, 16)
    got_s, got_z = td.gan_sample_batch(None, lambda z: z @ t(w), 5, 16,
                                       draws=t(jax.random.normal(key,
                                                                 (5, 16))))
    np.testing.assert_array_equal(got_z.numpy(), np.asarray(z))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(s), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("log_domain", [False, True])
def test_boundaries_from_samples_matches_jax(log_domain):
    """24 maps drawn in chunks of 24 (one key split per chunk)."""
    key = jax.random.PRNGKey(4)
    ref, ref_sd = jd.boundaries_from_samples(key, num_bins=4, num_samples=24,
                                             log_domain=log_domain)
    _, k = jax.random.split(key)
    got, sd = td.boundaries_from_samples(None, num_bins=4, num_samples=24,
                                         log_domain=log_domain,
                                         draws=[slf_draws(k, 24)])
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(sd, float(ref_sd), rtol=1e-3, atol=1e-8)


def test_port_draws_statistics():
    """The port's own draws: unit-Frobenius maps, peaks near the JAX
    package's (the mean peak of simulator SLFs is about 0.26), mask rates
    within [lo, hi], and one generator state giving one batch."""
    cfg = td.SLFBatchConfig(batch_size=64)
    maps = td.make_slf_sampler(device="cpu")(
        torch.Generator().manual_seed(0), 64)
    np.testing.assert_allclose(maps.flatten(1).norm(dim=1).numpy(), 1.0,
                               rtol=1e-5)
    assert 0.15 < maps.flatten(1).amax(1).mean().item() < 0.4
    ref = np.asarray(jd.make_slf_sampler(JPhys())(jax.random.PRNGKey(5), 64))
    assert abs(maps.flatten(1).amax(1).mean().item()
               - ref.reshape(64, -1).max(1).mean()) < 0.1
    inp, target = td.mask_batch(torch.Generator().manual_seed(1), maps, cfg)
    rates = inp[:, 0].flatten(1).mean(1)
    assert (rates > 0.0).all() and (rates < 0.3).all()
    assert torch.equal(inp[:, 1], inp[:, 0] * target[:, 0])
    it = td.slf_batches(torch.Generator().manual_seed(2),
                        td.SLFBatchConfig(batch_size=2))
    a, b = next(it), next(td.slf_batches(torch.Generator().manual_seed(2),
                                         td.SLFBatchConfig(batch_size=2)))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(next(it)[1], a[1])
