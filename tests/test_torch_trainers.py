"""The port's GAN and AAE trainers against the JAX package's, three steps
from the same initial weights (JAX's, mapped through
``state_dict_from_flax``) on the same random numbers (JAX's, passed as
``draws=``): the GAN with the BCE and the hinge loss (Generator64 against
the SN discriminator) and the AAE.  Held: each step's losses, the first
step's gradients, the weights, the BatchNorm running statistics and the
spectral vectors, at the tolerances `test_torch_train_support` states."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_train_support import (
    B,
    LOSS_RTOL,
    PHYS,
    STATS_TOL,
    STEPS,
    TOL,
    assert_grads_close,
    assert_losses,
    assert_tree_close,
    assert_weights_close,
    grads_of,
    nchw,
    normal,
    recording,
    slf_draws,
    stats_tree,
)

from quantized_spectrum_cartography_tpu import models as jm
from quantized_spectrum_cartography_tpu.config import PhysicsConfig as JPhys
from quantized_spectrum_cartography_tpu.data.datasets import (
    make_slf_sampler as jax_sampler,
)
from quantized_spectrum_cartography_tpu.training import aae_trainer as jaae
from quantized_spectrum_cartography_tpu.training import gan_trainer as jgan
from quantized_spectrum_cartography_tpu_torch import models as tm
from quantized_spectrum_cartography_tpu_torch.config import PhysicsConfig
from quantized_spectrum_cartography_tpu_torch.data.datasets import (
    make_slf_sampler,
)
from quantized_spectrum_cartography_tpu_torch.training import (
    aae_trainer as taae,
)
from quantized_spectrum_cartography_tpu_torch.training import (
    gan_trainer as tgan,
)
from quantized_spectrum_cartography_tpu_torch.training.checkpoints import (
    flax_from_generator,
    flax_from_state_dict,
    generator_state_dict_from_flax,
    state_dict_from_flax,
)

torch.set_num_threads(1)


# ------------------------------------------------------------------ GAN


def jax_init(module, key, *xs, **kw):
    """module.init under jit: JAX's init_gan / init_aae run flax's init
    eagerly, which compiles every layer on its own (20 s for the GAN)."""
    return jax.jit(lambda k: module.init(k, *xs, **kw))(key)


def jax_init_gan(key, cfg):
    """``gan_trainer.init_gan(key, cfg)`` of the JAX package, its inits
    under jit."""
    g = jm.make_generator(cfg.z_dim)
    d = jm.Discriminator(spectral_norm=cfg.spectral_norm,
                         output_logits=(cfg.loss == "hinge"))
    kg, kd = jax.random.split(key)
    gv = jax_init(g, kg, jnp.zeros((1, cfg.z_dim)), train=True)
    dv = jax_init(d, kd, jnp.zeros((1, 51, 51, 1)), train=True)
    opt_g = optax.adam(cfg.lr_g, b1=cfg.beta1)
    opt_d = optax.adam(cfg.lr_d, b1=cfg.beta1)
    state = jgan.GANState(
        g_params=gv["params"], g_batch_stats=gv["batch_stats"],
        d_params=dv["params"], d_batch_stats=dv["batch_stats"],
        d_spectral=dv["spectral_stats"], g_opt=opt_g.init(gv["params"]),
        d_opt=opt_d.init(dv["params"]))
    return g, d, opt_g, opt_d, state


@pytest.mark.parametrize("loss", ["bce", "hinge"])
def test_gan_three_steps_match_jax(loss):
    """Generator64 (z 64) against the SN discriminator, batch 4.  The D
    loss of step 1 is on the initial weights; the G loss of every step on
    a D one update along.  D's first-step gradient is held on JAX's real
    and fake batch: the two generators' fakes differ by rounding (about
    5e-7), and that may move a pre-activation of D across a LeakyReLU
    kink, which changes the first layers' gradient by percents."""
    cfg = jgan.GANTrainConfig(z_dim=64, batch_size=B, loss=loss)
    g, d, opt_g, opt_d, state = jax_init_gan(jax.random.PRNGKey(0), cfg)
    rec_g, rec_d = {}, {}
    step = jax.jit(jgan.make_train_step(
        g, d, recording(opt_g, rec_g), recording(opt_d, rec_d), cfg,
        jax_sampler(JPhys(**PHYS))))

    tcfg = tgan.GANTrainConfig(z_dim=64, batch_size=B, loss=loss)
    g_vars = {"params": state.g_params, "batch_stats": state.g_batch_stats}
    d_vars = {"params": state.d_params, "batch_stats": state.d_batch_stats,
              "spectral_stats": state.d_spectral}

    def port_d():
        td = tm.Discriminator(spectral_norm=True,
                              output_logits=(loss == "hinge"))
        td.load_state_dict(state_dict_from_flax(d_vars))
        return td.train()

    tg, td = tm.make_generator(64), port_d()
    tg.load_state_dict(generator_state_dict_from_flax(g_vars)[0])
    tg.train()
    tstep = tgan.make_train_step(
        tg, td, tgan.adam(tg.parameters(), tcfg.lr_g, tcfg.beta1),
        tgan.adam(td.parameters(), tcfg.lr_d, tcfg.beta1), tcfg,
        make_slf_sampler(PhysicsConfig(**PHYS), "cpu"))

    losses, ref = [], []
    for i in range(STEPS):
        key = jax.random.PRNGKey(10 + i)
        state, m = step(state, key)
        jax.effects_barrier()
        k_data, k_z1, k_z2 = jax.random.split(key, 3)
        got = tstep(draws=tgan.GANDraws(slf_draws(k_data, B),
                                        normal(k_z1, (B, 64)),
                                        normal(k_z2, (B, 64))))
        losses.append([got["d_loss"].item(), got["g_loss"].item()])
        ref.append([float(m["d_loss"]), float(m["g_loss"])])
        if i == 0:
            # D's on JAX's real and fake batch; G's through D as JAX's
            # D step left it
            real = jax_sampler(JPhys(**PHYS))(k_data, B)[..., None] \
                * cfg.scale
            fake, _ = g.apply(g_vars, jax.random.normal(k_z1, (B, 64)),
                              train=True, mutable=["batch_stats"])
            td0 = port_d()
            tgan.d_loss(td0, nchw(real), nchw(fake), tcfg).backward()
            assert_grads_close(grads_of(td0), state_dict_from_flax(
                {**d_vars, "params": rec_d["grads"][0]}))
            tg0 = tm.make_generator(64)
            tg0.load_state_dict(generator_state_dict_from_flax(g_vars)[0])
            td1 = tm.Discriminator(spectral_norm=True,
                                   output_logits=(loss == "hinge"))
            td1.load_state_dict(state_dict_from_flax(
                {"params": state.d_params,
                 "batch_stats": state.d_batch_stats,
                 "spectral_stats": state.d_spectral}))
            tgan.g_loss(tg0.train(), td1.train().requires_grad_(False),
                        normal(k_z2, (B, 64)), tcfg).backward()
            assert_grads_close(grads_of(tg0), generator_state_dict_from_flax(
                {**g_vars, "params": rec_g["grads"][0]})[0])
            # the running statistics after step 1 come from forwards on
            # the initial weights and the same batch: held tightly (G's
            # moved by both its forwards, D's and u by the real pass only)
            assert_tree_close(flax_from_generator(tg)["batch_stats"],
                              state.g_batch_stats, "G stats", **TOL)
            fd = flax_from_state_dict(td.state_dict())
            assert_tree_close(fd["batch_stats"], state.d_batch_stats,
                              "D stats", **TOL)
            assert_tree_close(fd["spectral_stats"], state.d_spectral, "u",
                              **TOL)
    losses, ref = np.asarray(losses), np.asarray(ref)
    assert_losses(losses[:, 0], ref[:, 0], "d_loss")
    np.testing.assert_allclose(losses[:, 1], ref[:, 1], rtol=LOSS_RTOL,
                               err_msg="g_loss")

    fg, fd = flax_from_generator(tg), flax_from_state_dict(td.state_dict())
    assert_weights_close(fg["params"], state.g_params, "G", cfg.lr_g)
    assert_weights_close(fd["params"], state.d_params, "D", cfg.lr_d)
    assert_tree_close(fg["batch_stats"], state.g_batch_stats, "G stats",
                      **STATS_TOL)
    assert_tree_close(fd["batch_stats"], state.d_batch_stats, "D stats",
                      **STATS_TOL)
    assert_tree_close(fd["spectral_stats"], state.d_spectral, "u",
                      **STATS_TOL)


# ------------------------------------------------------------------ AAE


def jax_init_aae(key, cfg):
    """``aae_trainer.init_aae(key, cfg)`` of the JAX package, its inits
    under jit."""
    enc, dec = jaae.AAEEncoder(z_dim=cfg.z_dim), jaae.AAEDecoder(
        z_dim=cfg.z_dim)
    dz = jaae.LatentDiscriminator()
    ke, kd, kz = jax.random.split(key, 3)
    ev = jax_init(enc, ke, jnp.zeros((1, 51, 51, 1)), train=True)
    dv = jax_init(dec, kd, jnp.zeros((1, cfg.z_dim)), train=True)
    zv = jax_init(dz, kz, jnp.zeros((1, cfg.z_dim)))
    opts = (optax.adam(cfg.lr_ae), optax.adam(cfg.lr_adv),
            optax.adam(cfg.lr_adv))
    state = jaae.AAEState(
        enc=ev["params"], dec=dv["params"], dz=zv["params"],
        enc_stats=ev["batch_stats"], dec_stats=dv["batch_stats"],
        opt_ae=opts[0].init((ev["params"], dv["params"])),
        opt_dz=opts[1].init(zv["params"]), opt_gen=opts[2].init(ev["params"]))
    return enc, dec, dz, opts, state


def test_aae_three_steps_match_jax():
    """z 16, batch 4: the three updates of each step, their three
    Adams."""
    cfg = jaae.AAETrainConfig(z_dim=16, batch_size=B)
    enc, dec, dz, opts, state = jax_init_aae(jax.random.PRNGKey(50), cfg)
    recs = ({}, {}, {})
    step = jaae.make_aae_step(
        enc, dec, dz, tuple(recording(o, r) for o, r in zip(opts, recs)),
        cfg, JPhys(**PHYS))

    tcfg = taae.AAETrainConfig(z_dim=16, batch_size=B)
    init = state

    def nets():
        enc, dec = taae.AAEEncoder(16), taae.AAEDecoder(16)
        enc.load_state_dict(state_dict_from_flax(
            {"params": init.enc, "batch_stats": init.enc_stats}))
        dec.load_state_dict(state_dict_from_flax(
            {"params": init.dec, "batch_stats": init.dec_stats}))
        return enc, dec

    (tenc, tdec), (enc0, dec0) = nets(), nets()
    tdz = taae.LatentDiscriminator(16)
    tdz.load_state_dict(state_dict_from_flax({"params": state.dz}))
    tstep = taae.make_aae_step(tenc, tdec, tdz,
                               taae.aae_optimizers(tenc, tdec, tdz, tcfg),
                               tcfg, PhysicsConfig(**PHYS))
    key = jax.random.PRNGKey(51)
    names = ("recon", "dz", "gen")
    losses, ref = [], []
    for i in range(STEPS):
        state, m = step(state, key)
        jax.effects_barrier()
        k_data, k_prior = jax.random.split(jax.random.fold_in(key, i))
        got = tstep(draws=taae.AAEDraws(slf_draws(k_data, B),
                                        normal(k_prior, (B, 16))))
        losses.append([got[n].item() for n in names])
        ref.append([float(m[n]) for n in names])
        if i == 0:
            # the reconstruction update's, on JAX's batch (the critic's
            # and the fooling update's follow it, on weights apart by its
            # noise moves: held through the losses and weights)
            x = jax_sampler(JPhys(**PHYS))(k_data, B)[..., None] * cfg.scale
            taae.recon_loss(enc0.train(), dec0.train(), nchw(x)).backward()
            g_enc, g_dec = recs[0]["grads"][0]
            assert_grads_close(grads_of(enc0), state_dict_from_flax(
                {"params": g_enc, "batch_stats": init.enc_stats}))
            assert_grads_close(grads_of(dec0), state_dict_from_flax(
                {"params": g_dec, "batch_stats": init.dec_stats}))
            for module, stats in ((tenc, state.enc_stats),
                                  (tdec, state.dec_stats)):
                assert_tree_close(stats_tree(module), stats, "stats", **TOL)
    # recon's first step is on the initial weights; the critic's and the
    # fooling loss follow an update
    losses, ref = np.asarray(losses), np.asarray(ref)
    assert_losses(losses[:, 0], ref[:, 0], "recon")
    np.testing.assert_allclose(losses[:, 1:], ref[:, 1:], rtol=LOSS_RTOL)
    # the encoder moves twice a step: by its AE Adam and its fooling Adam
    for name, module, params, stats, lr in (
            ("enc", tenc, state.enc, state.enc_stats,
             cfg.lr_ae + cfg.lr_adv),
            ("dec", tdec, state.dec, state.dec_stats, cfg.lr_ae)):
        got = flax_from_state_dict(module.state_dict())
        assert_weights_close(got["params"], params, name, lr)
        assert_tree_close(got["batch_stats"], stats, name + " stats",
                          **STATS_TOL)
    assert_weights_close(flax_from_state_dict(tdz.state_dict())["params"],
                         state.dz, "dz", cfg.lr_adv)
