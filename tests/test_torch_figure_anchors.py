"""The port's figure-anchor protocol (`figure_anchors`) against the JAX
package on fed inputs: the per-example statistics through JAX's
`best_permutation` and `tools/figure_anchors_tpu.py`'s NAE, the oracle-S C
refit through JAX's `nnls_rows`, the AE-manifold floor through JAX's
completer; the row layout and the gate on FIGURE_ANCHORS.json; `main` end
to end on the CPU with stand-in methods.

Tolerances: the statistics rtol 1e-6 (float64 numpy on identical arrays,
the same matching); the NNLS refit 1e-5 of the largest entry (200
accelerated steps in float32, tests/test_torch_baselines.py's bound); the
AE floor rtol 1e-4 (the AE's own parity)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_spectrum_cartography_tpu.baselines.harness import (
    best_permutation as jax_best_permutation,
)
from quantized_spectrum_cartography_tpu.baselines.nnls import (
    nnls_rows as jax_nnls_rows,
)
from quantized_spectrum_cartography_tpu_torch import figure_anchors as fa

torch.set_num_threads(1)


def jax_nae(a, b):
    """tools/figure_anchors_tpu.py's nae_np."""
    a = a / max(np.sum(np.abs(a)), 1e-12)
    b = b / max(np.sum(np.abs(b)), 1e-12)
    return float(np.sum(np.abs(a - b)))


@pytest.mark.parametrize("R", [2, 3])
def test_per_example_statistics_match_jax(R):
    rng = np.random.default_rng(R)
    B, K, I = 4, 6, 9
    S_true = rng.uniform(size=(B, R, I, I)).astype(np.float32)
    C_true = rng.uniform(size=(B, R, K)).astype(np.float32)
    # estimates: the truth's rows shuffled and perturbed
    S_hat, C_hat = np.empty_like(S_true), np.empty_like(C_true)
    for b in range(B):
        p = rng.permutation(R)
        S_hat[b] = S_true[b][p] + 0.2 * rng.uniform(size=(R, I, I))
        C_hat[b] = C_true[b][p] + 0.2 * rng.uniform(size=(R, K))
    T_true = np.einsum("brij,brk->bkij", S_true, C_true)
    T_hat = np.einsum("brij,brk->bkij", S_hat, C_hat)
    sres, naes_s, naes_c = fa.per_example(T_hat, S_hat, C_hat, T_true,
                                          S_true, C_true)
    want_s, want_c = [], []
    for b in range(B):
        perm = np.asarray(jax_best_permutation(jnp.asarray(S_hat[b]),
                                               jnp.asarray(S_true[b])))
        for r in range(R):
            want_s.append(jax_nae(S_true[b][r], S_hat[b][perm][r]))
            want_c.append(jax_nae(C_true[b][r], C_hat[b][perm][r]))
    want_sre = [float(np.sum((T_hat[b] - T_true[b]) ** 2)
                      / np.sum(T_true[b] ** 2)) for b in range(B)]
    np.testing.assert_allclose(sres, want_sre, rtol=1e-6)
    np.testing.assert_allclose(naes_s, want_s, rtol=1e-6)
    np.testing.assert_allclose(naes_c, want_c, rtol=1e-6)
    assert len(naes_s) == B * R


def test_oracle_c_matches_jax_nnls():
    """The C refit on the true S over the observed entries, against
    tools/figure_anchors_tpu.py's oracle_c on JAX's nnls_rows."""
    rng = np.random.default_rng(0)
    B, R, K, I = 2, 2, 16, 21
    S = rng.uniform(size=(B, R, I, I)).astype(np.float32) ** 2
    C = rng.uniform(size=(B, R, K)).astype(np.float32)
    Om = rng.uniform(size=(B, I, I)) < 0.1
    T = np.einsum("brij,brk->bkij", S, C) + 0.01 * rng.uniform(
        size=(B, K, I, I))
    T_obs = (T * Om[:, None]).astype(np.float32)
    got = fa.oracle_c(torch.tensor(S), torch.tensor(Om),
                      torch.tensor(T_obs)).numpy()
    for b in range(B):
        W = Om[b].astype(np.float32).reshape(1, -1)
        design = jnp.asarray((S[b].reshape(R, -1) * W).T)
        targ = jnp.asarray(T_obs[b].reshape(K, -1) * W)
        want = np.asarray(jax_nnls_rows(design, targ, iters=200).T)
        np.testing.assert_allclose(got[b], want, rtol=0.0,
                                   atol=1e-5 * np.abs(want).max())


def test_ae_floor_matches_jax_completer():
    from quantized_spectrum_cartography_tpu.models import Autoencoder
    from quantized_spectrum_cartography_tpu.training import (
        load_checkpoint as jax_load)
    from quantized_spectrum_cartography_tpu.training.ae_trainer import (
        make_ae_completer)
    from quantized_spectrum_cartography_tpu_torch.baselines import pretrained
    from quantized_spectrum_cartography_tpu_torch.training import ae_trainer

    rng = np.random.default_rng(2)
    S = (rng.uniform(size=(2, 2, 51, 51)) ** 4 * 0.1).astype(np.float32)
    got = fa.ae_floor(ae_trainer.make_ae_completer(*ae_trainer.load_ae(
        pretrained.AE_CKPT, "selu", "cpu")), torch.tensor(S))
    state = dict(jax_load(pretrained.AE_CKPT))
    scale = float(state.pop("scale"))
    ae = jax.jit(make_ae_completer(Autoencoder(activation="selu"), state,
                                   scale))
    ones = jnp.ones((51, 51))
    want = [jax_nae(S[b][r], np.asarray(ae(ones, jnp.asarray(S[b][r]))))
            for b in range(2) for r in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_smooth_floor():
    """An SLF that is the path-loss kernel itself has floor 0; a shadowed
    one a positive floor."""
    I = 15
    yy, xx = np.mgrid[:I, :I].astype(np.float64)
    d = np.sqrt((yy - 4) ** 2 + (xx - 9) ** 2)
    kern = np.minimum((np.maximum(d, 1e-6) / 2.0) ** -2.25, 1.0)
    shadow = kern * np.exp(np.random.default_rng(0).normal(0, 0.5, (I, I)))
    out = fa.smooth_floor(np.stack([kern, shadow])[None],
                          np.asarray([[[9.0, 4.0], [9.0, 4.0]]]))
    assert out[0] < 1e-12 and out[1] > 0.05


def test_rows_and_gate_on_the_jax_artifact():
    """method_row keeps FIGURE_ANCHORS.json's layout; the gate of JAX's
    own per-example lists against JAX is z = 0, and a hand-moved mean is
    flagged."""
    with open(fa.REFERENCE) as f:
        ref = json.load(f)
    for name in fa.METHODS:
        jrow = ref["methods"][name]
        raw = {"sre_map": jrow["sre_map_sorted"],
               "nae_c": jrow["nae_c_sorted"],
               "nae_s": list(np.linspace(0.2, 0.5, 128))}
        row = fa.method_row(name, raw["sre_map"], raw["nae_s"],
                            raw["nae_c"])
        assert set(jrow) <= set(row)
        for key in ("sre_map", "nae_c_per_emitter"):
            assert set(row[key]) == set(jrow[key])
        assert row["sre_map"]["n"] == 64 and row["nae_c_per_emitter"][
            "n"] == 128
        g = fa.gate(row, jrow, raw)
        assert g["sre_map"]["z"] == 0 and g["nae_c"]["z"] == 0 and g["pass"]
        moved = dict(raw, sre_map=[v + 4 * g["sre_map"]["se_port"] * 2 ** 0.5
                                   for v in raw["sre_map"]])
        g = fa.gate(row, jrow, moved)
        assert not g["sre_map"]["in_band"] and not g["pass"]
        assert g["sre_map"]["z"] == pytest.approx(4.0, rel=1e-2)


def _oracle(generator, hp):
    return {"T_hat": hp.T_true, "S_hat": hp.S_true.flip(-3),
            "C_hat": hp.C_true.flip(-2)}


def _scaled(generator, hp):
    return {"T_hat": 3.0 * hp.T_true, "S_hat": hp.S_true,
            "C_hat": hp.C_true}


def test_main_end_to_end_on_cpu(tmp_path, monkeypatch):
    """main with stand-in methods on 2 examples: the document's layout,
    the diagnostics, a method out of band drawn again at seed + 1."""
    from quantized_spectrum_cartography_tpu_torch import baselines

    monkeypatch.setattr(baselines, "load_pretrained_methods",
                        lambda only, device: {"nasdac": _oracle,
                                              "dowjons": _scaled})
    out = tmp_path / "fa.json"
    doc = fa.main(["--examples", "2", "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text())["num_examples"] == 2
    nas = doc["methods"]["nasdac"]
    assert nas["sre_map"]["mean"] == 0.0               # matched despite flip
    assert nas["nae_s_per_emitter"]["mean"] == 0.0
    assert nas["nae_c_per_emitter"]["mean"] == 0.0
    assert doc["methods"]["dowjons"]["sre_map"]["mean"] == 4.0
    per = doc["gate"]["per_method"]         # far from JAX's: both redrawn
    assert not per["dowjons"]["pass"] and not per["nasdac"]["pass"]
    assert [sorted(d["methods"]) for d in doc["gate"]["redraws"]] == [
        ["dowjons", "nasdac"]]
    assert doc["gate"]["redraws"][0]["seed"] == 1 and not doc["gate"]["pass"]
    for k in ("oracle_s_cfit", "oracle_smooth_naes_floor",
              "oracle_ae_manifold_floor"):
        st = [x for x in doc["methods"][k].values()
              if isinstance(x, dict)][0]
        assert st["n"] == 4 and np.isfinite(st["mean"])
    assert doc["device"] == {"platform": "cpu"}
    with pytest.raises(SystemExit):
        fa.main(["--out", "FIGURE_ANCHORS.json"])
