"""The port's DowJons on small CPU solves: its spans (`qsc.dowjons.*`) nest
under the registry method's `qsc.dowjons.solve` and carry their keys; `aux`
names the winning restart (`best`, the argmin of the restarts' final
residuals, which it reports), the restarts' starts and the init fit's
costs; recording spans
changes no bit of the answer.  And the benchmark's plain reference decoder
(`port_bench/reference/dowjons.py`) against the port's VAE decoder at the
published z256 widths on seeded random weights."""

import json
from pathlib import Path

import pytest
import torch

from quantized_spectrum_cartography_tpu_torch.baselines.harness import (
    Condition,
    make_problem,
    standard_methods,
)
from quantized_spectrum_cartography_tpu_torch.config import PhysicsConfig
from quantized_spectrum_cartography_tpu_torch.models import VAE
from quantized_spectrum_cartography_tpu_torch.ops.lowrank import get_tensor
from quantized_spectrum_cartography_tpu_torch.solvers.completion import (
    recover_dowjons_unquantized,
)
from quantized_spectrum_cartography_tpu_torch.utils import tracing

ROOT = Path(__file__).resolve().parents[1]
Z_DIM, B, R = 8, 2, 2


@pytest.fixture(scope="module")
def gen():
    """A small VAE decoder (latent 8, the narrowest widths) as G."""
    torch.manual_seed(0)
    vae = VAE(latent_dim=Z_DIM, dec_width=2).eval().requires_grad_(False)
    return lambda Z: vae.decode(Z)[:, 0] * 0.26


@pytest.fixture(scope="module")
def hp():
    return make_problem(torch.Generator().manual_seed(1), Condition(),
                        PhysicsConfig(num_bands=16), batch=B, device="cpu")


def draws(restarts, seed=2):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, R, Z_DIM, generator=g),
            torch.randn(B, restarts, R, Z_DIM, generator=g))


def method(gen, iters=2, restarts=2):
    return standard_methods(gen_apply=gen, z_dim=Z_DIM, dowjons_iters=iters,
                            dowjons_restarts=restarts)["dowjons"]


def test_spans_nest_and_carry_their_keys(gen, hp):
    d = draws(2)
    tracing.clear()
    with torch.no_grad():
        out = method(gen)(None, hp, draws=d)
    recs = tracing.spans()
    solve = [r for r in recs if r[0] == "qsc.dowjons.solve"]
    assert len(solve) == 1 and solve[0][5] == (B, 2, 2)
    sid, lo, hi = solve[0][3], solve[0][1], solve[0][2]
    kids = sorted((r for r in recs if r[4] == sid), key=lambda r: r[1])
    assert [r[0] for r in kids] == [
        "qsc.dowjons.spa", "qsc.dowjons.init_fit",
        "qsc.dowjons.c_step", "qsc.dowjons.z_steps",
        "qsc.dowjons.c_step", "qsc.dowjons.z_steps",
        "qsc.dowjons.c_step", "qsc.dowjons.pick"]
    assert all(lo <= r[1] <= r[2] <= hi for r in kids)
    keys = {r[0]: r[5] for r in kids}
    assert keys["qsc.dowjons.init_fit"] == 150
    assert keys["qsc.dowjons.z_steps"] == 20
    # every qsc.dowjons span of the call is the solve or one of its children
    assert len([r for r in recs if r[0].startswith("qsc.dowjons.")]) == 9
    # the method reports the solve's diagnostics beside its estimate
    assert out["costs"].shape == (B, 2) and out["init_costs"].shape == (B, 150)
    assert out["S_init"].shape == (B, R, 51, 51)
    assert torch.equal(out["Z_start"][:, 1:], d[1][:, 1:])
    assert not torch.equal(out["Z_start"][:, 0], d[1][:, 0])
    assert out["best"].shape == (B,) and out["Z"].shape == (B, R, Z_DIM)
    assert out["residuals"].shape == (B, 2)


def test_best_is_the_argmin_of_the_restarts_final_residuals(gen, hp):
    """Without an SPA start the restarts are independent, so each one run
    alone gives its own final residual; `best` is their argmin and the
    returned costs and latents are that restart's."""
    _, Z = draws(3, seed=5)
    kw = dict(num_emitters=R, z_dim=Z_DIM, outer_iters=2, z_steps_per_iter=3,
              nnls_iters=10)
    with torch.no_grad():
        res = recover_dowjons_unquantized(hp.T_obs, hp.Om, gen, n_restarts=3,
                                          draws=(None, Z), **kw)
        alone = [recover_dowjons_unquantized(
            hp.T_obs, hp.Om, gen, n_restarts=1, draws=(None, Z[:, r:r + 1]),
            **kw) for r in range(3)]
    W = hp.Om.to(hp.T_obs.dtype)[:, None]
    final = torch.stack([(W * (get_tensor(a.S, a.C) - hp.T_obs).square())
                         .sum((-3, -2, -1)) for a in alone], -1)
    best = res.aux["best"]
    assert torch.equal(best, torch.argmin(final, -1))
    # the residuals it reports are those final residuals, `best` their argmin
    torch.testing.assert_close(res.aux["residuals"], final, rtol=1e-5,
                               atol=0.0)
    assert torch.equal(best, torch.argmin(res.aux["residuals"], -1))
    assert torch.equal(res.aux["Z_start"], Z)
    assert "init_costs" not in res.aux
    for b in range(B):
        a = alone[int(best[b])]
        torch.testing.assert_close(res.costs[b], a.costs[b], rtol=1e-5,
                                   atol=0.0)
        torch.testing.assert_close(res.aux["Z"][b], a.aux["Z"][b],
                                   rtol=1e-5, atol=1e-6)


def test_spans_off_gives_the_same_bits(gen, hp):
    d = draws(2, seed=7)
    fn = method(gen)
    with torch.no_grad():
        on = fn(None, hp, draws=d)
        tracing.set_enabled(False)
        try:
            tracing.clear()
            off = fn(None, hp, draws=d)
            assert not tracing.spans()
        finally:
            tracing.set_enabled(True)
    assert sorted(on) == sorted(off)
    for k in on:
        assert torch.equal(on[k], off[k]), k


def test_reference_decoder_matches_the_vae_decoder():
    """The benchmark's float64 reference decoder against `VAE.decode` (the
    port, float32) at the published z256 widths, on seeded random weights
    handed to the port as the flax tree its loader reads.  Tolerance 1e-5
    relative: float32 accumulation over at most 256 x 9 = 2,304 products a
    layer through nine layers is about 1e-6 (5e-7 measured)."""
    from port_bench import dowjons_inputs
    from port_bench.reference import dowjons as ref
    from port_bench.reference.numerics import JUDGE
    from quantized_spectrum_cartography_tpu_torch.solvers.vae_prior import (
        make_vae_generator)

    pr = json.loads((ROOT / "port_bench" / "configs" /
                     "dowjons-vae-z256.json").read_text())["prior"]
    w = dowjons_inputs.decoder_weights(torch.Generator().manual_seed(11), pr)
    G = make_vae_generator(dowjons_inputs.flax_tree(w, pr),
                           latent_dim=pr["latent_dim"], beta=pr["beta"],
                           amp=pr["amp"], head=pr["head"],
                           dec_width=pr["dec_width"],
                           refine_width=pr["refine_width"], device="cpu")
    Z = torch.randn(4, pr["latent_dim"], generator=torch.Generator()
                    .manual_seed(12))
    got = G(Z)
    want = ref.decoder_forward(w, pr, Z.double(), JUDGE)
    assert got.shape == want.shape == (4, 51, 51)
    gap = torch.linalg.vector_norm(got.double() - want) / \
        torch.linalg.vector_norm(want)
    assert gap < 1e-5, float(gap)
    # the weights matter: another draw moves the map by far more
    w2 = dowjons_inputs.decoder_weights(torch.Generator().manual_seed(13), pr)
    other = ref.decoder_forward(w2, pr, Z.double(), JUDGE)
    assert torch.linalg.vector_norm(other - want) > 1e-2 * \
        torch.linalg.vector_norm(want)
