"""The port's completion-AE and VAE trainers against the JAX package's,
three steps from the same initial weights on the same random numbers (see
test_torch_trainers.py): the AE in each data mode, the VAE with free bits,
peak weight, MSE and BCE, the KL warm-up, the stepped learning rate and
EMA; then the held-out ELBO."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_support import (
    B,
    LOSS_RTOL,
    PHYS,
    STATS_TOL,
    STEPS,
    assert_grads_close,
    assert_losses,
    assert_tree_close,
    assert_weights_close,
    grads_of,
    nchw,
    normal,
    band_draws,
    mask_draws,
    recording_optax,
    slf_draws,
    stats_tree,
    step_keys,
)

from quantized_spectrum_cartography_tpu import models as jm
from quantized_spectrum_cartography_tpu.config import PhysicsConfig as JPhys
from quantized_spectrum_cartography_tpu.data.datasets import (
    make_slf_sampler as jax_sampler,
)
from quantized_spectrum_cartography_tpu.data import datasets as jd
from quantized_spectrum_cartography_tpu.training import ae_trainer as jae
from quantized_spectrum_cartography_tpu.training import vae_trainer as jvae
from quantized_spectrum_cartography_tpu_torch import models as tm
from quantized_spectrum_cartography_tpu_torch.config import PhysicsConfig
from quantized_spectrum_cartography_tpu_torch.training import ae_trainer as tae
from quantized_spectrum_cartography_tpu_torch.training import (
    vae_trainer as tvae,
)
from quantized_spectrum_cartography_tpu_torch.training.checkpoints import (
    flax_from_state_dict,
    state_dict_from_flax,
)

torch.set_num_threads(1)


# ------------------------------------------------------------------- AE


def ae_maps_draws(mode, key, R=2):
    if mode == "slf":
        return slf_draws(key, B)
    if mode == "band":
        return band_draws(key, B, R)
    ka, kb = jax.random.split(key)
    return slf_draws(ka, B // 2), band_draws(kb, B - B // 2, R)


def jax_ae_maps(mode, key, R=2):
    """The maps of JAX ``train_ae``'s sampler closures for `mode`."""
    slf = jax_sampler(JPhys(**PHYS))

    def band(k, n):
        ka, kb = jax.random.split(k)
        slfs = slf(ka, n * R).reshape(n, R, 51, 51)
        return jnp.sum(slfs * jnp.abs(jax.random.normal(kb, (n, R, 1, 1)))
                       * 0.3, axis=1)

    if mode == "slf":
        return slf(key, B)
    if mode == "band":
        return band(key, B)
    ka, kb = jax.random.split(key)
    return jnp.concatenate([slf(ka, B // 2), band(kb, B - B // 2)])


@pytest.mark.parametrize("mode", ["slf", "band", "mixed"])
def test_ae_three_steps_match_jax(mode, monkeypatch):
    """The selu Autoencoder, batch 4, peak-weighted MSE."""
    store = {}
    monkeypatch.setattr(jae, "optax", recording_optax(store))
    cfg = jae.AETrainConfig(batch_size=B, steps=STEPS, data_mode=mode)
    key = jax.random.PRNGKey(20)
    logs = []
    variables, diag = jae.train_ae(key, cfg, JPhys(**PHYS), log_every=1,
                                   log_fn=logs.append)
    jax.effects_barrier()

    model = tm.Autoencoder()
    model.load_state_dict(state_dict_from_flax(
        {"params": store["init"], "batch_stats": stats_tree(model)}))
    draws = []
    for k in step_keys(key):
        k1, k2 = jax.random.split(k)
        draws.append(tae.AEDraws(ae_maps_draws(mode, k1),
                                 mask_draws(k2, (B, 51, 51))))
    tcfg = tae.AETrainConfig(batch_size=B, steps=STEPS, data_mode=mode)
    k1, k2 = jax.random.split(step_keys(key)[0])
    inp, target = jd.mask_batch(k2, jax_ae_maps(mode, k1) * cfg.scale,
                                jd.SLFBatchConfig(batch_size=B))
    tae.ae_loss(model.train(), nchw(inp), nchw(target),
                cfg.peak_weight).backward()
    assert_grads_close(grads_of(model), state_dict_from_flax(
        {"params": store["grads"][0], "batch_stats": stats_tree(model)}))
    model.zero_grad(set_to_none=True)
    model.load_state_dict(state_dict_from_flax(
        {"params": store["init"], "batch_stats": stats_tree(tm.Autoencoder())}))
    trained, tdiag = tae.train_ae(None, tcfg, PhysicsConfig(**PHYS),
                                  log_every=1, log_fn=lambda *a: None,
                                  draws=draws, model=model)
    assert_losses([m[1] for m in tdiag["metrics"]],
                  [m[1] for m in diag["metrics"]])
    got = flax_from_state_dict(trained.state_dict())
    assert_weights_close(got["params"], variables["params"], "AE", cfg.lr)
    assert_tree_close(got["batch_stats"], variables["batch_stats"],
                      "AE stats", **STATS_TOL)
    assert tdiag["scale"] == diag["scale"]


# ------------------------------------------------------------------ VAE


VAE_CASES = {
    # KL warm-up over 2 steps and the learning rate halved after 2, so
    # three steps see both move
    "mse_softplus_peak_ema": dict(recon="mse", head="softplus",
                                  peak_weight=2.0, ema_decay=0.5),
    "bce_peak_free_bits": dict(peak_weight=2.0),
    "bce_plain": dict(free_bits=0.0),
}


@pytest.mark.parametrize("case", sorted(VAE_CASES))
def test_vae_three_steps_match_jax(case, monkeypatch):
    kw = dict(latent_dim=8, batch_size=B, steps=STEPS, kl_warmup_steps=2,
              lr_decay_steps=2, **VAE_CASES[case])
    store = {}
    monkeypatch.setattr(jvae, "optax", recording_optax(store))
    cfg = jvae.VAETrainConfig(**kw)
    key = jax.random.PRNGKey(30)
    variables, diag = jvae.train_vae(key, cfg, JPhys(**PHYS), log_every=1,
                                     log_fn=lambda *a: None)
    jax.effects_barrier()

    tcfg = tvae.VAETrainConfig(**kw)
    model = tvae.vae_model(tcfg)
    model.load_state_dict(state_dict_from_flax(
        {"params": store["init"], "batch_stats": stats_tree(model)}))
    draws = []
    for k in step_keys(key):
        k1, k2, k3 = jax.random.split(k, 3)
        draws.append(tvae.VAEDraws(slf_draws(k1, B),
                                   mask_draws(k2, (B, 51, 51)),
                                   normal(k3, (B, 8))))
    k1, k2, k3 = jax.random.split(step_keys(key)[0], 3)
    inp, target = jd.mask_batch(
        k2, jax_sampler(JPhys(**PHYS))(k1, B),
        jd.SLFBatchConfig(batch_size=B, normalize_peak=True))
    tvae.vae_loss(model.train(), nchw(inp), nchw(target),
                  normal(k3, (B, 8)), tcfg, 0.0)[0].backward()
    assert_grads_close(grads_of(model), state_dict_from_flax(
        {"params": store["grads"][0], "batch_stats": stats_tree(model)}))
    model.zero_grad(set_to_none=True)
    model.load_state_dict(state_dict_from_flax(
        {"params": store["init"],
         "batch_stats": stats_tree(tvae.vae_model(tcfg))}))
    trained, info = tvae.train_vae(None, tcfg, PhysicsConfig(**PHYS),
                                   log_every=1, log_fn=lambda *a: None,
                                   draws=draws, model=model)
    for col, name in ((1, "total"), (2, "bce"), (3, "kl")):
        assert_losses(np.asarray(info["metrics"])[:, col],
                      np.asarray(diag["metrics"])[:, col], name)
    got = flax_from_state_dict(trained.state_dict())
    assert_weights_close(got["params"], variables["params"], "VAE", cfg.lr)
    assert_tree_close(got["batch_stats"], variables["batch_stats"],
                      "VAE stats", **STATS_TOL)
    if cfg.ema_decay > 0.0:
        ema = flax_from_state_dict(info["variables_ema"])
        assert_weights_close(ema["params"], diag["variables_ema"]["params"],
                             "EMA", cfg.lr)
    else:
        assert "variables_ema" not in info


def test_heldout_elbo_matches_jax():
    cfg = jvae.VAETrainConfig(latent_dim=8, batch_size=B)
    variables = jax.jit(lambda k: jm.VAE(latent_dim=8).init(
        k, jnp.zeros((1, 51, 51, 2)), jax.random.PRNGKey(0), train=True))(
        jax.random.PRNGKey(40))
    key = jax.random.PRNGKey(41)
    ref = jvae.heldout_elbo(cfg, variables, JPhys(**PHYS), key, batches=2)
    draws = []
    for i in range(2):
        k1, k2, k3 = jax.random.split(jax.random.fold_in(key, i), 3)
        draws.append(tvae.VAEDraws(slf_draws(k1, B),
                                   mask_draws(k2, (B, 51, 51)),
                                   normal(k3, (B, 8))))
    model = tvae.vae_model(tvae.VAETrainConfig(latent_dim=8))
    model.load_state_dict(state_dict_from_flax(variables))
    got = tvae.heldout_elbo(tvae.VAETrainConfig(latent_dim=8, batch_size=B),
                            model, PhysicsConfig(**PHYS), batches=2,
                            draws=draws)
    for name in ("bce", "kl", "elbo_loss"):
        np.testing.assert_allclose(got[name], ref[name], rtol=LOSS_RTOL,
                                   err_msg=name)
