"""The port's evaluation harness against the JAX package's: the examples
from JAX's own draws, the accumulation rules (validity caps, (total+1)
denominators) on identical arrays, run_conditions against BatchedHarness
on a shared problem, the registries, evaluate_method, and `cli sweep` /
`cli conditions --device cpu` against JAX's result structure.  The five
methods end to end are in tests/test_torch_methods.py.

Tolerances: the harness's own arithmetic is exact (equal floats on equal
arrays), but for the NAE that run_conditions takes in f32 torch and
BatchedHarness in numpy (rtol 1e-6, as in JAX); the examples rtol 1e-6."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_spectrum_cartography_tpu import cli as jcli
from quantized_spectrum_cartography_tpu.baselines import harness as jh
from quantized_spectrum_cartography_tpu.config import PhysicsConfig as JPhys
from quantized_spectrum_cartography_tpu.physics import generate_map
from quantized_spectrum_cartography_tpu_torch import cli as tcli
from quantized_spectrum_cartography_tpu_torch.baselines import harness as th
from quantized_spectrum_cartography_tpu_torch.baselines import (
    load_pretrained_methods,
    pretrained,
)
from quantized_spectrum_cartography_tpu_torch.config import PhysicsConfig

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


# -- the examples -----------------------------------------------------------

@pytest.mark.parametrize("snr", [None, 10.0])
def test_problem_from_jax_draws_matches_make_problem(snr):
    """JAX make_problem's draws (the map, the uniform noise, the
    permutation) through problem_from_draws give its example; the samples
    come row-major, JAX's in permutation order."""
    pcfg = JPhys(decorrelation_distance=30.0, **SMALL)
    cond = jh.Condition(fraction=0.2, snr=snr)
    key = jax.random.PRNGKey(0)
    want = jh.make_problem(key, cond, pcfg)
    k_map, k_noise, k_mask = jax.random.split(key, 3)
    mcfg = dataclasses.replace(pcfg, num_emitters=2, shadow_sigma=5.0,
                               decorrelation_distance=50.0, psd_basis="s",
                               separable=True)
    T, S, C, peaks = generate_map(k_map, mcfg)
    noise = jax.random.uniform(k_noise, T.shape)
    perm = jax.random.permutation(k_mask, 21 * 21)
    got = th.problem_from_draws(t(T)[None], t(S)[None], t(C)[None],
                                t(peaks)[None],
                                th.Condition(fraction=0.2, snr=snr),
                                t(noise)[None], t(perm)[None])
    close(got.T_true[0].numpy(), want.T_true, rtol=1e-6)
    close(got.T_noisy[0].numpy(), want.T_noisy, rtol=1e-6)
    close(got.T_obs[0].numpy(), want.T_obs, rtol=1e-6)
    np.testing.assert_array_equal(got.Om[0].numpy(), np.asarray(want.Om))
    idx = np.asarray(want.sample_idx)
    order = np.argsort(idx[:, 0] * 21 + idx[:, 1])
    np.testing.assert_array_equal(got.sample_idx[0].numpy(), idx[order])


def test_make_problem_batch():
    """Exactly round(f*IJ) observed locations per example, listed
    row-major; noise only adds; one generator gives one batch."""
    cond = th.Condition(fraction=0.05, snr=20.0, num_emitters=3)
    pcfg = PhysicsConfig(**SMALL)

    def batch():
        return th.make_problem(torch.Generator().manual_seed(3), cond, pcfg,
                               batch=4, device="cpu")

    hp = batch()
    assert hp.T_true.shape == (4, 16, 21, 21) and hp.C_true.shape == (4, 3, 16)
    assert hp.Om.sum((-2, -1)).tolist() == [round(0.05 * 441)] * 4
    for b in range(4):
        np.testing.assert_array_equal(hp.sample_idx[b].numpy(),
                                      np.argwhere(hp.Om[b].numpy()))
    assert (hp.T_noisy >= hp.T_true).all()
    torch.testing.assert_close(batch().T_noisy, hp.T_noisy, rtol=0, atol=0)


def test_condition_grid_matches():
    assert th.REFERENCE_AXES == jh.REFERENCE_AXES
    assert th.DEFAULT_VALIDITY_CAPS == jh.DEFAULT_VALIDITY_CAPS
    assert th.SAMPLE_IDX_METHODS == jh.SAMPLE_IDX_METHODS
    for axis in (None, *jh.REFERENCE_AXES):
        got = [dataclasses.asdict(c) | {"label": c.label()}
               for c in th.condition_grid(axis)]
        want = [dataclasses.asdict(c) | {"label": c.label()}
                for c in jh.condition_grid(axis)]
        assert got == want


def test_registries():
    """Aliasing: 'dowjons' is the chosen variant, popped from its key;
    load_pretrained_methods resolves its checkpoints from the package and
    refuses an unknown name."""
    def fn(*a):
        return None

    for variant in ("gan", "ae_latent"):
        kw = dict(dowjons_variant=variant, gen_apply=fn, ae_complete=fn,
                  ae_input_apply=fn, ae_latent_fns=(fn, fn))
        got = th.standard_methods(**kw)
        want = jh.standard_methods(**kw)
        assert sorted(got) == sorted(want)
        assert f"dowjons_{variant}" not in got
    assert sorted(th.standard_methods()) == ["btd", "tps"]
    assert pretrained.REPO_ROOT.joinpath("checkpoints").is_dir()
    assert pretrained.AE_CKPT.endswith("checkpoints/ae_completion/final")
    with pytest.raises(KeyError, match="unknown method"):
        load_pretrained_methods(only=("dowjons_gan",), device="cpu")
    assert sorted(load_pretrained_methods(only=("tps", "dowjons"),
                                          device="cpu")) == ["dowjons", "tps"]


# -- the accumulation rules -------------------------------------------------

PER_EXAMPLE = ("miss_all", "peak_all", "false_all", "low_all", "valid_all")


def same_as_jax(got: dict, want: dict, counts, s, cap):
    """JAX's statistics exactly, plus the port's per-example events: the
    counts as given, the validity flags of the cap, and the sums over the
    valid examples equal to the aggregate counts."""
    assert set(got) == set(want) | set(PER_EXAMPLE)
    same({k: got[k] for k in want}, want)
    valid = np.ones(len(s), bool) if cap is None else np.asarray(s) < cap
    assert got["valid_all"] == valid.tolist()
    for key, c in zip(("miss", "peak", "false", "low"), counts):
        assert got[f"{key}_all"] == c.tolist()
        agg = "peak_count" if key == "peak" else (
            "low_count" if key == "low" else f"{key}_count")
        assert sum(x for x, v in zip(got[f"{key}_all"], valid) if v) \
            == got[agg]


def test_accumulate_matches_jax():
    """_accumulate on identical arrays: validity cap (2 of 6 over it),
    permutation-matched NAE, event counts, (total+1) denominators; the
    port's per-example events beside them."""
    rng = np.random.default_rng(5)
    B, R = 6, 3
    s = np.asarray([0.5, 3.5, 1.0, 7.0, 0.2, 2.9])
    counts = [rng.integers(0, 40, B) for _ in range(4)]
    res = {"T_hat": rng.uniform(size=(B, 4, 5, 5)).astype(np.float32),
           "S_hat": rng.uniform(size=(B, R, 5, 5)).astype(np.float32),
           "C_hat": rng.uniform(size=(B, R, 4)).astype(np.float32)}
    arrs = {"S_true": rng.uniform(size=(B, R, 5, 5)).astype(np.float32),
            "C_true": rng.uniform(size=(B, R, 4)).astype(np.float32)}
    cond = jh.Condition()
    for name in ("btd", "nasdac"):
        want = jh.BatchedHarness({}, JPhys())._accumulate(
            name, cond, res, arrs, s, *counts)
        got = th.BatchedHarness({}, device="cpu")._accumulate(
            name, cond, {k: t(v) for k, v in res.items()}, arrs, s, *counts)
        same_as_jax(got, want, counts, s, th.DEFAULT_VALIDITY_CAPS.get(name))
    assert got["valid"] == 6 and want["miss_prob"] == (
        counts[0].sum() / (counts[1].sum() + 1))
    res.pop("S_hat")
    want = jh.BatchedHarness({}, JPhys())._accumulate(
        "btd", cond, res, arrs, s, *counts)
    got = th.BatchedHarness({}, device="cpu")._accumulate(
        "btd", cond, res, arrs, s, *counts)
    same_as_jax(got, want, counts, s, 3.0)
    assert want["valid"] == 4 and np.isnan(got["nae_s"])


def _oracle(generator, hp):
    return {"T_hat": hp.T_true, "S_hat": hp.S_true, "C_hat": hp.C_true}


def _zero(generator, hp):
    return {"T_hat": torch.zeros_like(hp.T_true)}


def _flaky(generator, hp):
    bad = torch.rand(hp.T_true.shape[0], generator=generator) < 0.5
    scale = torch.where(bad, 10.0, 1.0)[:, None, None, None]
    return {"T_hat": hp.T_true * scale, "S_hat": hp.S_true,
            "C_hat": hp.C_true}


def test_batched_semantics():
    """The oracle scores 0, the zero map misses every peak event (with the
    (total+1) denominator), the validity cap drops examples from every
    accumulator."""
    h = th.BatchedHarness({"oracle": _oracle, "zero": _zero,
                           "flaky": _flaky}, PhysicsConfig(**SMALL),
                          validity_caps={"flaky": 3.0}, device="cpu")
    (label, st), = h.run(th.condition_grid(), num_examples=8, seed=2).items()
    o, z, f = st["oracle"], st["zero"], st["flaky"]
    assert o["sre"] < 1e-9 and o["nae_s"] < 1e-6 and o["nae_c"] < 1e-6
    assert o["miss_count"] == 0 and o["false_count"] == 0 and o["valid"] == 8
    assert abs(z["sre"] - 1.0) < 1e-6 and z["false_count"] == 0
    assert z["miss_count"] == z["peak_count"] > 0
    assert z["miss_prob"] == z["peak_count"] / (z["peak_count"] + 1)
    sre_all = np.asarray(f["sre_all"])
    assert 0 < f["valid"] == int((sre_all < 3.0).sum()) < 8
    assert np.isclose(f["sre"], sre_all[sre_all < 3.0].mean())
    assert set(h.seconds[label]) == {"oracle", "zero", "flaky"}


def test_run_conditions_matches_batched_on_shared_problem():
    """With one example, run_conditions and BatchedHarness draw the same
    example and the same method streams: equal results (the NAE in f32
    torch there, in numpy here, as in JAX: rtol 1e-6); and the batched
    event counts are the sums of per-example detection counts."""
    from quantized_spectrum_cartography_tpu_torch.ops.metrics import (
        detection_counts)

    methods = th.standard_methods(btd_restarts=2)
    methods.update(oracle=_oracle, flaky=_flaky)
    pcfg = PhysicsConfig(**SMALL)
    conds = th.condition_grid("snr", (None, 10.0))
    seq = th.run_conditions(methods, conds, num_examples=1, physics=pcfg,
                            seed=7, device="cpu")
    bat = th.BatchedHarness(methods, pcfg, device="cpu").run(conds, 1, seed=7)
    for label in seq:
        for name, st in seq[label].items():
            b = bat[label][name]
            same(st, {k: b[k] for k in st}, rtol=1e-6)
    h = th.BatchedHarness({"zero": _zero}, pcfg, device="cpu")
    hp = th.make_problem(torch.Generator().manual_seed(0), th.Condition(),
                         pcfg, batch=3, device="cpu")
    miss = peaks = 0
    for b in range(3):
        m, p, _, _ = detection_counts(torch.zeros_like(hp.T_true[b]),
                                      hp.T_noisy[b], hp.peaks[b])
        miss, peaks = miss + int(m), peaks + int(p)
    st = h.run((th.Condition(),), 3, seed=0)[th.Condition().label()]["zero"]
    assert (st["miss_count"], st["peak_count"]) == (miss, peaks)


def test_evaluate_method_matches():
    rng = np.random.default_rng(6)
    T = rng.uniform(size=(4, 6, 6)).astype(np.float32)
    T_hat = T * rng.uniform(0.5, 1.5, T.shape).astype(np.float32)
    S = rng.uniform(size=(2, 6, 6)).astype(np.float32)
    C = rng.uniform(size=(2, 4)).astype(np.float32)
    peaks = np.asarray([[1.0, 2.0], [4.0, 3.0]], np.float32)
    want = jh.evaluate_method(*map(jnp.asarray, (T_hat, T, S[::-1], C[::-1],
                                                  S, C, peaks)))
    got = th.evaluate_method(*map(t, (T_hat, T, S[::-1].copy(),
                                      C[::-1].copy(), S, C, peaks)))
    np.testing.assert_allclose(got.sre_map, want.sre_map, rtol=1e-6)
    np.testing.assert_allclose(got.nae_s + got.nae_c,
                               want.nae_s + want.nae_c, rtol=1e-5, atol=1e-7)
    assert got.detected == want.detected


# -- the command line -------------------------------------------------------

def _structure(x):
    if isinstance(x, dict):
        return {k: _structure(v) for k, v in x.items()}
    return type(x).__name__ if not isinstance(x, (int, float)) else "number"


def test_cli_sweep_and_conditions(capsys):
    """`sweep` and `conditions --device cpu` print JAX's result structure
    (the same keys at every level)."""
    argv = ["sweep", "--fractions", "0.2", "--examples", "1"]
    tcli.main(argv + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    jcli.main(argv)
    want = json.loads(capsys.readouterr().out)
    assert _structure(got) == _structure(want)
    assert np.isfinite(got["tps"]["0.2"]["sre"])

    argv = ["conditions", "--methods", "tps", "--examples", "1"]
    jcli.main(argv)
    want = json.loads(capsys.readouterr().out)
    tcli.main(argv[:3] + ["deepcomp", "--ae-checkpoint", AE_CKPT]
              + argv[3:] + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    (label, st), = got.items()
    assert _structure(want) == {label: {"tps": _structure(st["tps"])}}
    assert _structure(st["deepcomp"]) == _structure(st["tps"])
    assert label == th.Condition().label() and st["deepcomp"]["valid"] == 1
    with pytest.raises(SystemExit, match="unavailable"):
        tcli.main(["conditions", "--methods", "nasdac", "--device", "cpu"])


def test_published_sre_summary_and_guard(tmp_path):
    """published_sre.py's row: BTD's statistics on its SRE < 3 examples,
    the 12.5%-per-tail trimmed mean, the sorted SREs; it refuses to write
    the JAX package's PUBLISHED_SRE.json."""
    from quantized_spectrum_cartography_tpu_torch import published_sre

    sres = [0.5, 4.0, 1.0, 2.0, 0.25, 1.5, 3.5, 1.25, 0.75, 1.75]
    st = {"sre_all": sres, "nae_s": float("nan"), "nae_c": 0.123456,
          "miss_prob": 0.1, "false_prob": 0.0}
    row = published_sre.summarize(st, 1.2288, cap=3.0)
    valid = np.sort([x for x in sres if x < 3.0])
    assert row["valid"] == 8 and row["sre_sorted"] == sorted(sres)
    assert row["sre_mean"] == round(float(valid.mean()), 4)
    assert row["sre_median"] == round(float(np.median(valid)), 4)
    assert row["sre_trimmed_mean_12.5pct_each_tail"] == round(
        float(valid[1:-1].mean()), 4)
    assert row["nae_s"] is None and row["nae_c"] == 0.1235
    with pytest.raises(SystemExit):
        published_sre.main(["--device", "cpu", "--out",
                            str(tmp_path / "PUBLISHED_SRE.json")])
    assert not (tmp_path / "PUBLISHED_SRE.json").exists()
