"""DowJons on quantized observations: the port's `recover_dowjons` against the
JAX package's under the trained VAE decoder (checkpoints/vae_best/final,
read by each package's own reader) on a problem the decoder realizes (cut
to K=8), from the same Z_init and C_init; the CLI's `recover --solver
dowjons`."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from quantized_spectrum_cartography_tpu.config import (
    QuantizerConfig as JQuant,
    SolverConfig as JSolver,
)
from quantized_spectrum_cartography_tpu.ops import boundaries as jbnd
from quantized_spectrum_cartography_tpu.ops.quantizer import quantize_log
from quantized_spectrum_cartography_tpu.solvers import (
    recover_dowjons as jax_recover,
)
from quantized_spectrum_cartography_tpu.solvers import vae_prior as jv
from quantized_spectrum_cartography_tpu_torch.cli import main as cli_main
from quantized_spectrum_cartography_tpu_torch.config import (
    QuantizerConfig,
    SolverConfig,
)
from quantized_spectrum_cartography_tpu_torch.solvers import recover_dowjons
from quantized_spectrum_cartography_tpu_torch.solvers import vae_prior as tv

torch.set_num_threads(1)

K, R, Z_DIM = 8, 2, 128
QUANT = dict(boundaries=jbnd.QUANTIZATION_BOUNDARIES_4_BINS_LOG,
             noise_std=5.0, domain="log", log_offset=jbnd.LOG_OFFSET_4)
SOLVER = dict(max_iters=5, z_dim=Z_DIM, lr_c=0.02, lr_z=0.02)


def t(x):
    return torch.tensor(np.array(x))


def test_matches_jax_solver():
    """Costs, NMSEs, C and Z within rtol 1e-3 (atol 1e-6 of each array's
    largest entry), as tests/test_torch_mle_gan.py holds MLE-GAN; costs
    finite, C >= 0."""
    jgen, _, _ = jv.load_vae_prior("checkpoints/vae_best/final")
    tgen, _, _ = tv.load_vae_prior("checkpoints/vae_best/final",
                                   device="cpu")
    kz, kc, kq, km, ki, kj = jax.random.split(jax.random.PRNGKey(3), 6)
    T_true = jnp.einsum("rij,rk->kij",
                        jgen(jax.random.normal(kz, (R, Z_DIM))),
                        jnp.abs(jax.random.normal(kc, (R, K))))
    Y = quantize_log(kq, T_true, QUANT["noise_std"],
                     jnp.asarray(np.array(QUANT["boundaries"])),
                     QUANT["log_offset"])
    mask = jax.random.bernoulli(km, 0.3, Y.shape).astype(jnp.float32)
    Z0 = jax.random.normal(ki, (R, Z_DIM))
    C0 = jnp.abs(jax.random.normal(kj, (R, K))) * 0.1
    ref = jax_recover(jax.random.PRNGKey(0), Y, mask, jgen, JSolver(**SOLVER),
                      JQuant(**QUANT), Z_init=Z0, C_init=C0, num_emitters=R,
                      T_true=T_true)
    port = recover_dowjons(t(Y), t(mask), tgen, SolverConfig(**SOLVER),
                           QuantizerConfig(**QUANT), Z_init=t(Z0),
                           C_init=t(C0), num_emitters=R, T_true=t(T_true))
    for name, a, b in (("costs", port.costs, ref.costs),
                       ("nmses", port.nmses, ref.nmses),
                       ("C", port.C, ref.C),
                       ("Z", port.aux["Z"], ref.aux["Z"]),
                       ("T_hat", port.T_hat, ref.T_hat)):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=1e-3,
                                   atol=1e-6 * np.abs(b).max(), err_msg=name)
    assert torch.isfinite(port.costs).all() and (port.C >= 0).all()


def test_cli_recover_dowjons(tmp_path, capsys):
    """`recover --solver dowjons` on the CPU under the default VAE prior:
    one-line JSON, the factors written with --out."""
    out = str(tmp_path / "res.npz")
    cli_main(["recover", "--solver", "dowjons", "--iters", "3", "--device",
              "cpu", "--out", out])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["solver"] == "dowjons" and res["iters"] == 3
    assert np.isfinite(res["final_cost"]) and np.isfinite(res["final_nmse"])
    saved = np.load(out)
    assert saved["S"].shape == (2, 51, 51) and (saved["C"] >= 0).all()
