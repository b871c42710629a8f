"""The five published methods of the port's `standard_methods` end to end
against the JAX package's on one JAX-made HarnessProblem: TPS and BTD at
PhysicsConfig(grid_size=21, num_bands=16), DeepComp, Nasdac and DowJons
at 51x51, K=16 (the autoencoder's size) under the committed checkpoints
read by each package's loader; every random start is JAX's, passed in as
`draws`; JAX's methods run under jax.jit.

Tolerances: TPS 1e-3 of the largest entry (JAX's float32 solve of the
ill-conditioned system, see tests/test_torch_baselines.py); DeepComp 1e-4 of the largest entry (the
AE's rtol 1e-4 / atol 1e-5); Nasdac, BTD and DowJons end to end 2e-3 of
the largest entry: BTD's 50 sweeps and DowJons' 170 Adam steps carry the
f32 rounding that tests/test_torch_baselines.py and
tests/test_torch_completion.py bound per step."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from quantized_spectrum_cartography_tpu.baselines import harness as jh
from quantized_spectrum_cartography_tpu.config import PhysicsConfig as JPhys
from quantized_spectrum_cartography_tpu.models import Autoencoder as JAE
from quantized_spectrum_cartography_tpu.solvers import vae_prior as jv
from quantized_spectrum_cartography_tpu.training import ae_trainer as jae
from quantized_spectrum_cartography_tpu.training import (
    load_checkpoint as jax_load,
)
from quantized_spectrum_cartography_tpu_torch.baselines import harness as th
from quantized_spectrum_cartography_tpu_torch.solvers import vae_prior as tv
from quantized_spectrum_cartography_tpu_torch.training import ae_trainer as tae

torch.set_num_threads(1)

SMALL = dict(grid_size=21, num_bands=16)
AE_CKPT = "checkpoints/ae_completion/final"
VAE_CKPT = "checkpoints/vae_peak_z256"


def t(x):
    return torch.tensor(np.array(x))


def close(got, want, rtol=1e-4, atol_rel=1e-6, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * np.abs(want).max(),
                               err_msg=err_msg)


def jit_method(fn, key, jhp):
    """A JAX method on a JAX HarnessProblem, compiled as one program."""
    fields = [f.name for f in dataclasses.fields(jh.HarnessProblem)
              if f.name != "fraction"]

    def call(*arrays):
        return fn(key, jh.HarnessProblem(**dict(zip(fields, arrays)),
                                         fraction=jhp.fraction))

    return jax.jit(call)(*(getattr(jhp, f) for f in fields))


def same(got: dict, want: dict, rtol=0.0):
    """Equal statistics (NaN equal to NaN; floats within rtol)."""
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, float):
            np.testing.assert_allclose(got[k], v, rtol=rtol, err_msg=k)
        else:
            assert got[k] == v, k


def port_problem(jhp) -> th.HarnessProblem:
    """A JAX HarnessProblem as the port's batch of one."""
    return th.HarnessProblem(**{
        f.name: (getattr(jhp, f.name) if f.name == "fraction"
                 else t(getattr(jhp, f.name))[None])
        for f in dataclasses.fields(th.HarnessProblem)})


# -- the five methods end to end --------------------------------------------

def jax_btd_draws(key, restarts, R, I, J, K, L=5):
    keys = list(jax.random.split(key, restarts))
    out = [[], [], []]
    for k in keys:
        ka, kb, kc = jax.random.split(k, 3)
        for i, x in enumerate((jax.random.normal(ka, (R, I, L)),
                               jax.random.normal(kb, (R, J, L)),
                               jax.random.normal(kc, (R, K)))):
            out[i].append(np.asarray(x))
    return [t(np.stack(x))[None] for x in out]


def test_tps_and_btd_end_to_end():
    """standard_methods' tps and btd on one JAX example at 21x21x16."""
    jhp = jh.make_problem(jax.random.PRNGKey(1), jh.Condition(fraction=0.2),
                          JPhys(**SMALL))
    hp = port_problem(jhp)
    key = jax.random.PRNGKey(2)
    jm = jh.standard_methods(btd_restarts=3)
    tm = th.standard_methods(btd_restarts=3)
    want = jit_method(jm["tps"], key, jhp)["T_hat"]
    close(tm["tps"](None, hp)["T_hat"][0].numpy(), want, rtol=0.0,
          atol_rel=1e-3)
    want = jit_method(jm["btd"], key, jhp)
    got = tm["btd"](None, hp, draws=jax_btd_draws(key, 3, 2, 21, 21, 16))
    for name, k in (("T_hat", "T_hat"), ("S", "S_hat"), ("C", "C_hat")):
        close(got[k][0].numpy(), want[k], rtol=0.0, atol_rel=2e-3,
              err_msg=name)


@pytest.fixture(scope="module")
def deep():
    """The committed AE and VAE through both packages' loaders, and one
    base-condition example at 51x51, K=16, made by JAX."""
    state = dict(jax_load(AE_CKPT))
    scale = float(state.pop("scale"))
    jfn = jae.make_ae_completer(JAE(), state, scale)
    jgen, z_dim, _ = jv.load_vae_prior(VAE_CKPT)
    model, _ = tae.load_ae(AE_CKPT, "selu", "cpu")
    tgen, _, _ = tv.load_vae_prior(VAE_CKPT, device="cpu")
    kw = dict(z_dim=z_dim, btd_restarts=1, dowjons_iters=2,
              dowjons_restarts=2)
    jm = jh.standard_methods(gen_apply=jgen, ae_complete=jfn, **kw)
    tm = th.standard_methods(gen_apply=tgen,
                             ae_complete=tae.make_ae_completer(model, scale),
                             **kw)
    jhp = jh.make_problem(jax.random.PRNGKey(3), jh.Condition(),
                          JPhys(num_bands=16))
    return jm, tm, jhp, port_problem(jhp), z_dim


@pytest.mark.parametrize("name,tol", [("deepcomp", 1e-4), ("nasdac", 2e-3)])
def test_ae_methods_end_to_end(deep, name, tol):
    jm, tm, jhp, hp, _ = deep
    want = jit_method(jm[name], jax.random.PRNGKey(0), jhp)
    with torch.no_grad():
        got = tm[name](None, hp)
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k][0].numpy(), want[k], rtol=0.0, atol_rel=tol, err_msg=k)


def test_dowjons_end_to_end(deep):
    """The registry's dowjons (SPA + AE init, restarts, the no-extinguish
    backstop, the residual patches) from JAX's draws, depth cut to 2 outer
    iterations and 2 restarts."""
    jm, tm, jhp, hp, z_dim = deep
    key = jax.random.PRNGKey(4)
    want = jit_method(jm["dowjons"], key, jhp)
    fit = t(jax.random.normal(jax.random.fold_in(key, 17), (2, z_dim)))
    starts = torch.stack([t(jax.random.normal(k, (2, z_dim)))
                          for k in jax.random.split(key, 2)])
    with torch.no_grad():
        got = tm["dowjons"](None, hp, draws=(fit[None], starts[None]))
    for k in want:
        close(got[k][0].numpy(), want[k], rtol=0.0, atol_rel=2e-3, err_msg=k)


