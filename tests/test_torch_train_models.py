"""The models that prior training adds to the port, against the flax modules
of the JAX package on the same weights and inputs: the spectral norm, the
discriminators, the AAE's three nets, and the flax BatchNorm's running
statistics, in train and eval mode, forward and gradient; flax's
initializers; the flax <-> torch mapping both ways on every model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_spectrum_cartography_tpu import models as jm
from quantized_spectrum_cartography_tpu.models import aae as jaae
from quantized_spectrum_cartography_tpu.models import spectral_norm as jsn
from quantized_spectrum_cartography_tpu_torch import models as tm
from quantized_spectrum_cartography_tpu_torch.models import aae as taae
from quantized_spectrum_cartography_tpu_torch.models import layers as tlayers
from quantized_spectrum_cartography_tpu_torch.models import (
    spectral_norm as tsn,
)
from quantized_spectrum_cartography_tpu_torch.training.checkpoints import (
    flax_from_generator,
    flax_from_state_dict,
    generator_state_dict_from_flax,
    state_dict_from_flax,
)

torch.set_num_threads(1)

# forward values and running statistics: float32 convolutions in two
# libraries; gradients: relative to the largest |entry| of each tensor
TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL = 1e-4
N = 4


def t(x):
    return torch.tensor(np.array(x))


def nchw(x):
    return t(np.transpose(np.asarray(x), (0, 3, 1, 2)))


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def assert_trees_close(got, want, **tol):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        np.testing.assert_allclose(got[k], v, err_msg=k, **tol)


def assert_grads_close(module, jax_grads, variables):
    """Each parameter's .grad against flax's gradient tree (mapped through
    the same mapper as the weights): within GRAD_RTOL of the tensor's
    largest |entry| plus GRAD_RTOL of the whole gradient's (a bias in
    front of a train-mode BatchNorm has a gradient of rounding noise)."""
    want = state_dict_from_flax({**variables, "params": jax_grads})
    want = {n: want[n].numpy() for n, _ in module.named_parameters()}
    scale = max(np.abs(w).max() for w in want.values())
    for name, p in module.named_parameters():
        w = want[name]
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= GRAD_RTOL * (np.abs(w).max() + scale), (name, err)


def images(seed, n=N, channels=1):
    """Positive maps at the scaled-SLF amplitude, NHWC."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (n, 51, 51, channels)).astype(np.float32)


# ---------------------------------------------------------------- spectral


def test_power_iteration_value_grad_and_u():
    rng = np.random.default_rng(0)
    W = rng.normal(size=(16, 48)).astype(np.float32)
    u = rng.normal(size=(1, 16)).astype(np.float32)
    for steps in (1, 3):
        (sig, new_u), vjp = jax.vjp(
            lambda w: jsn.power_iteration(w, jnp.asarray(u), steps),
            jnp.asarray(W))
        (g,) = vjp((jnp.float32(1.0), jnp.zeros_like(new_u)))
        Wt = t(W).requires_grad_(True)
        tsig, tu = tsn.power_iteration(Wt, t(u), steps)
        tsig.backward()
        assert not tu.requires_grad
        np.testing.assert_allclose(tsig.item(), float(sig), rtol=1e-5)
        np.testing.assert_allclose(tu.numpy(), np.asarray(new_u), **TOL)
        # the gradient flows through the iteration, not only sigma = u W v
        np.testing.assert_allclose(Wt.grad.numpy(), np.asarray(g),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("train", [True, False])
def test_snconv_matches_flax(train):
    """Output, kernel gradient and the written-back u (only in train
    mode), stride 2 with padding, on a batch of 4."""
    jconv = jsn.SNConv(8, 4, 2, 1)
    x = images(1, channels=3)
    variables = jconv.init(jax.random.PRNGKey(2), jnp.asarray(x))
    cot = np.random.default_rng(3).normal(size=(N, 25, 25, 8)).astype(
        np.float32)

    def loss(params):
        y, mut = jconv.apply({**variables, "params": params},
                             jnp.asarray(x), update_stats=train,
                             mutable=["spectral_stats"])
        return jnp.sum(y * cot), (y, mut)

    (_, (y, mut)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    conv = tsn.SNConv(3, 8, 4, 2, 1)
    conv.weight.data = tlayers_conv(variables["params"]["kernel"])
    conv.u = t(variables["spectral_stats"]["u"])
    conv.train(train)
    out = conv(nchw(x))
    (out * nchw(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(),
                               np.transpose(np.asarray(y), (0, 3, 1, 2)),
                               **TOL)
    want = tlayers_conv(g["kernel"]).numpy()
    assert np.abs(conv.weight.grad.numpy() - want).max() \
        <= GRAD_RTOL * np.abs(want).max()
    u_after = mut["spectral_stats"]["u"] if train else \
        variables["spectral_stats"]["u"]
    np.testing.assert_allclose(conv.u.numpy(), np.asarray(u_after), **TOL)
    if not train:
        assert np.array_equal(conv.u.numpy(),
                              np.asarray(variables["spectral_stats"]["u"]))


def tlayers_conv(kernel):
    return t(kernel).permute(3, 2, 0, 1).contiguous()


# ----------------------------------------------------------- batch norm


def test_batchnorm_running_stats_match_flax():
    """One train forward at batch 4 on a 3x3 map (the discriminator's
    last BN stage): flax moves the running variance by the *biased* batch
    variance, torch's BatchNorm2d by the unbiased one (n/(n-1) = 36/35
    apart here); frozen_stats leaves them alone; eval uses them."""
    rng = np.random.default_rng(4)
    x = rng.normal(1.0, 2.0, (N, 3, 3, 16)).astype(np.float32)
    jbn = jm.layers.BatchNorm()
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True)
    y, mut = jbn.apply(variables, jnp.asarray(x), train=True,
                       mutable=["batch_stats"])
    bn = tlayers.BatchNorm(16).train()
    got = bn(nchw(x))
    np.testing.assert_allclose(got.detach().numpy(),
                               np.transpose(np.asarray(y), (0, 3, 1, 2)),
                               **TOL)
    stats = mut["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), **TOL)
    torch_bn = torch.nn.BatchNorm2d(16, momentum=0.1).train()
    torch_bn(nchw(x))
    assert not np.allclose(torch_bn.running_var.numpy(),
                           np.asarray(stats["var"]), rtol=1e-3)

    before = (bn.running_mean.clone(), bn.running_var.clone())
    with tlayers.frozen_stats(bn):
        again = bn(nchw(x))
    assert torch.equal(again, got)
    assert torch.equal(bn.running_mean, before[0])
    assert torch.equal(bn.running_var, before[1])
    assert bn.update_stats

    ev = jbn.apply({**variables, **mut}, jnp.asarray(x), train=False)
    np.testing.assert_allclose(bn.eval()(nchw(x)).detach().numpy(),
                               np.transpose(np.asarray(ev), (0, 3, 1, 2)),
                               **TOL)


# -------------------------------------------------------- discriminators


DISC_CASES = {
    "sn_sigmoid": dict(spectral_norm=True),
    "sn_logits": dict(spectral_norm=True, output_logits=True),
    "plain_sigmoid": dict(),
}


@pytest.mark.parametrize("case", sorted(DISC_CASES))
def test_discriminator_matches_flax(case):
    """Train mode: output, every parameter's gradient, the BatchNorm
    running statistics and spectral vectors written back; then eval mode
    on the updated statistics."""
    kw = DISC_CASES[case]
    jd = jm.Discriminator(**kw)
    x = images(5) * 0.6
    variables = jax.jit(lambda k: jd.init(k, jnp.zeros((1, 51, 51, 1)),
                                          train=True))(jax.random.PRNGKey(6))
    cot = np.random.default_rng(7).normal(size=(N, 1)).astype(np.float32)
    mutable = [c for c in ("batch_stats", "spectral_stats")
               if c in variables]

    @jax.jit
    def run(params):
        def loss(p):
            y, mut = jd.apply({**variables, "params": p}, jnp.asarray(x),
                              train=True, mutable=mutable)
            return jnp.sum(y * cot), (y, mut)
        return jax.value_and_grad(loss, has_aux=True)(params)

    (_, (y, mut)), g = run(variables["params"])
    d = tm.Discriminator(**kw)
    d.load_state_dict(state_dict_from_flax(variables))
    out = d.train()(nchw(x))
    (out * t(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), **TOL)
    assert_grads_close(d, g, variables)
    new_vars = {**variables, **mut}
    assert_trees_close(flax_from_state_dict(d.state_dict()), new_vars,
                       **TOL)
    ev = jax.jit(lambda v: jd.apply(v, jnp.asarray(x), train=False))(
        new_vars)
    with torch.no_grad():
        got = d.eval()(nchw(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ev), **TOL)
    assert jm.SNDiscriminator().spectral_norm \
        and all(isinstance(c, tsn.SNConv) for c in tm.SNDiscriminator().conv)


# ------------------------------------------------------------------ AAE


def aae_case(name, z_dim=16):
    x = images(8) * 0.5
    z = np.random.default_rng(9).normal(size=(N, z_dim)).astype(np.float32)
    return {
        "encoder": (jaae.AAEEncoder(z_dim=z_dim), taae.AAEEncoder(z_dim),
                    x, nchw(x), (N, z_dim)),
        "decoder": (jaae.AAEDecoder(z_dim=z_dim), taae.AAEDecoder(z_dim),
                    z, t(z), (N, 51, 51, 1)),
    }[name]


@pytest.mark.parametrize("name", ["encoder", "decoder"])
def test_aae_nets_match_flax(name):
    """Train mode (batch statistics, running ones moved) with every
    parameter's gradient, then eval mode."""
    jnet, tnet, x, tx, shape = aae_case(name)
    variables = jax.jit(lambda k: jnet.init(k, jnp.asarray(x[:1]),
                                            train=True))(
        jax.random.PRNGKey(10))
    cot = np.random.default_rng(11).normal(size=shape).astype(np.float32)

    @jax.jit
    def run(params):
        def loss(p):
            y, mut = jnet.apply({**variables, "params": p}, jnp.asarray(x),
                                train=True, mutable=["batch_stats"])
            return jnp.sum(y * cot), (y, mut)
        return jax.value_and_grad(loss, has_aux=True)(params)

    (_, (y, mut)), g = run(variables["params"])
    tnet.load_state_dict(state_dict_from_flax(variables))
    out = tnet.train()(tx)
    tcot = nchw(cot) if len(shape) == 4 else t(cot)
    (out * tcot).sum().backward()
    y = np.asarray(y)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.transpose(y, (0, 3, 1, 2)) if y.ndim == 4 else y, **TOL)
    assert_grads_close(tnet, g, variables)
    new_vars = {**variables, **mut}
    assert_trees_close(flax_from_state_dict(tnet.state_dict()), new_vars,
                       **TOL)
    ev = np.asarray(jax.jit(lambda v: jnet.apply(v, jnp.asarray(x),
                                                 train=False))(new_vars))
    with torch.no_grad():
        got = tnet.eval()(tx).numpy()
    np.testing.assert_allclose(
        got, np.transpose(ev, (0, 3, 1, 2)) if ev.ndim == 4 else ev, **TOL)


def test_latent_discriminator_matches_flax():
    z = np.random.default_rng(12).normal(size=(N, 16)).astype(np.float32)
    jd = jaae.LatentDiscriminator()
    variables = jd.init(jax.random.PRNGKey(13), jnp.asarray(z))

    def loss(p):
        y = jd.apply({"params": p}, jnp.asarray(z))
        return jnp.sum(y ** 2), y

    (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    d = taae.LatentDiscriminator(z_dim=16)
    d.load_state_dict(state_dict_from_flax(variables))
    out = d(t(z))
    assert out.shape == (N,)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), **TOL)
    assert_grads_close(d, g, variables)


# ------------------------------------------------------- initializers


def _flax_init(module, *xs, **kw):
    return jax.jit(lambda k: module.init(k, *xs, **kw))(
        jax.random.PRNGKey(14))


INIT_CASES = {
    "generator256": (lambda: jm.make_generator(256),
                     lambda: tm.Generator256(seed=0),
                     lambda: (jnp.zeros((1, 256)),), dict(train=True)),
    "sn_discriminator": (lambda: jm.Discriminator(spectral_norm=True),
                         lambda: tm.SNDiscriminator(),
                         lambda: (jnp.zeros((1, 51, 51, 1)),),
                         dict(train=True)),
    "aae_encoder": (lambda: jaae.AAEEncoder(z_dim=64),
                    lambda: taae.AAEEncoder(64),
                    lambda: (jnp.zeros((1, 51, 51, 1)),), dict(train=True)),
    "latent_discriminator": (lambda: jaae.LatentDiscriminator(),
                             lambda: taae.LatentDiscriminator(64),
                             lambda: (jnp.zeros((1, 64)),), {}),
}


@pytest.mark.parametrize("case", sorted(INIT_CASES))
def test_flax_initializer_statistics(case):
    """flax_init_ draws as flax does: each kernel's standard deviation
    within 10% (kernels of >= 1000 entries; a normal truncated at two sd
    of variance 1/fan_in, fan_in the HWIO kernel's in x kh x kw) of
    flax's own kernel of the same layer and of 1/sqrt(fan_in), no entry
    past the truncation, biases 0, BatchNorm scale 1, u standard normal."""
    jmod, tmod, xs, kw = INIT_CASES[case]
    ref = _flax_init(jmod(), *xs(), **kw)
    module = tmod()
    tlayers.flax_init_(module, torch.Generator().manual_seed(15))
    sd = module.state_dict()
    got = (flax_from_generator(module) if case == "generator256"
           else flax_from_state_dict(sd))
    want = dict(leaves(ref["params"]))
    mine = dict(leaves(got["params"]))
    assert sorted(mine) == sorted(want)
    for k, w in want.items():
        v = mine[k]
        if k.endswith("kernel"):
            fan_in = int(np.prod(w.shape[:-1]))
            std = fan_in ** -0.5
            assert np.abs(v).max() <= 2.0 * std / 0.87962566103423978 * 1.0001
            if v.size >= 1000:
                assert abs(v.std() / std - 1.0) < 0.1, (k, v.std(), std)
                assert abs(v.std() / w.std() - 1.0) < 0.1, k
        elif k.endswith("scale"):
            assert np.array_equal(v, np.ones_like(w)), k
        else:
            assert np.array_equal(v, np.zeros_like(w)), k
    if "spectral_stats" in ref:
        u = np.concatenate([v.ravel() for _, v in
                            leaves(got["spectral_stats"])])
        assert abs(u.std() - 1.0) < 0.3 and abs(u.mean()) < 0.3
    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            assert torch.equal(m.running_mean, torch.zeros_like(
                m.running_mean))
            assert torch.equal(m.running_var, torch.ones_like(m.running_var))


def test_flax_batchnorm_draws_nothing():
    """Generator256(seed=...) draws the weights it drew with torch's
    BatchNorm2d: the flax BatchNorm draws no random numbers."""
    state = torch.random.get_rng_state()
    bn = tlayers.BatchNorm(16)
    assert torch.equal(state, torch.random.get_rng_state())
    assert all(isinstance(b, tlayers.BatchNorm)
               for b in tm.Generator256(seed=3).bn)
    assert isinstance(bn, torch.nn.BatchNorm2d)


# ------------------------------------------------------------- mapping


MAP_CASES = {
    "generator64": (lambda: jm.make_generator(64),
                    lambda: tm.make_generator(64), (jnp.zeros((1, 64)),),
                    dict(train=True)),
    "generator256": (lambda: jm.make_generator(256),
                     lambda: tm.make_generator(256),
                     (jnp.zeros((1, 256)),), dict(train=True)),
    "sn_discriminator": (lambda: jm.Discriminator(spectral_norm=True),
                         lambda: tm.SNDiscriminator(),
                         (jnp.zeros((1, 51, 51, 1)),), dict(train=True)),
    "discriminator": (lambda: jm.Discriminator(), lambda: tm.Discriminator(),
                      (jnp.zeros((1, 51, 51, 1)),), dict(train=True)),
    "aae_encoder": (lambda: jaae.AAEEncoder(z_dim=16),
                    lambda: taae.AAEEncoder(16),
                    (jnp.zeros((1, 51, 51, 1)),), dict(train=True)),
    "aae_decoder": (lambda: jaae.AAEDecoder(z_dim=16),
                    lambda: taae.AAEDecoder(16), (jnp.zeros((1, 16)),),
                    dict(train=True)),
    "latent_discriminator": (lambda: jaae.LatentDiscriminator(),
                             lambda: taae.LatentDiscriminator(16),
                             (jnp.zeros((1, 16)),), {}),
    "vae_scaled_refine": (lambda: jm.VAE(latent_dim=8, head="scaled_sigmoid",
                                         refine_width=8),
                          lambda: tm.VAE(latent_dim=8, head="scaled_sigmoid",
                                         refine_width=8),
                          (jnp.zeros((1, 51, 51, 2)), jax.random.PRNGKey(0)),
                          dict(train=True)),
    "autoencoder_linear": (lambda: jm.AutoencoderLinear(32),
                           lambda: tm.AutoencoderLinear(32),
                           (jnp.zeros((1, 51, 51, 2)),), dict(train=True)),
}


@pytest.mark.parametrize("case", sorted(MAP_CASES))
def test_flax_tree_round_trip(case):
    """The flax tree of a port module has flax's paths and shapes (those
    of the JAX module's init, from jax.eval_shape), and
    state_dict_from_flax then flax_from_state_dict gives it back bit for
    bit, every leaf drawn at random (generators through their
    renaming)."""
    jmake, tmake, xs, kw = MAP_CASES[case]
    want = jax.eval_shape(lambda k: jmake().init(k, *xs, **kw),
                          jax.random.PRNGKey(0))
    module = tmake()
    rng = np.random.default_rng(16)
    for v in module.state_dict().values():
        if v.is_floating_point():
            v.copy_(t(rng.normal(size=v.shape).astype(np.float32)))
    generator = case.startswith("generator")
    tree = flax_from_generator(module) if generator else \
        flax_from_state_dict(module.state_dict())
    got = dict(leaves(tree))
    shapes = {"/".join(str(getattr(k, "key", k)) for k in path): v.shape
              for path, v in jax.tree_util.tree_leaves_with_path(want)}
    assert {k: v.shape for k, v in got.items()} == shapes
    if generator:
        sd, _ = generator_state_dict_from_flax(tree)
        module.load_state_dict(sd)
        back = flax_from_generator(module)
    else:
        back = flax_from_state_dict(state_dict_from_flax(tree))
    back = dict(leaves(back))
    assert sorted(back) == sorted(got)
    for k, v in got.items():
        assert back[k].dtype == v.dtype == np.float32, k
        assert np.array_equal(back[k], v), k
