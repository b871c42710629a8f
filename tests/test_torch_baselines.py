"""The port's baselines (NNLS, SPA, TPS, BTD) and the harness's factor
matching against the JAX package's, on the same numpy-seeded inputs; every
random start of BTD is drawn by JAX and passed in.

Tolerances: rtol 1e-4 (atol 1e-6 of the largest entry) for the closed-form
and fixed-iteration code; TPS 1e-3 of the largest entry, because its
(N+3)^2 system is ill-conditioned (phi reaches ~1e4): JAX solves it in
float32, which is off by up to ~1e-3, the port in float64; BTD 1e-4 of the largest entry where every
row of the factors sees most of its entries (70% observed), 5e-3 where the
rows of this 9x7 toy see one or two (40% observed): there the per-row
ridge systems amplify f32 rounding from ~4e-5 after one sweep to ~2e-3
after four; discrete choices (SPA's columns, BTD's restart winner) must
be equal."""

import importlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_spectrum_cartography_tpu.baselines import (
    best_permutation as jax_best_permutation,
)
from quantized_spectrum_cartography_tpu_torch.baselines import (
    best_permutation,
    column_sum_normalize,
    nmf_spa,
    nnls,
    nnls_rows,
    spa_indices,
    tps_complete,
)
from quantized_spectrum_cartography_tpu_torch.baselines.btd import (
    _ridge_solve,
    btd_ll1,
)
from quantized_spectrum_cartography_tpu_torch.baselines.nnls import nnls_gram

jbtd = importlib.import_module("quantized_spectrum_cartography_tpu.baselines.btd")
jnnls = importlib.import_module(
    "quantized_spectrum_cartography_tpu.baselines.nnls")
jspa = importlib.import_module("quantized_spectrum_cartography_tpu.baselines.spa")
jtps = importlib.import_module("quantized_spectrum_cartography_tpu.baselines.tps")

torch.set_num_threads(1)


def t(x):
    return torch.tensor(np.array(x))


def close(got, want, rtol=1e-4, atol_rel=1e-6, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * np.abs(want).max(),
                               err_msg=err_msg)


@pytest.mark.parametrize("iters", [10, 200])
def test_nnls_matches(rng, iters):
    """nnls, nnls_gram and nnls_rows on signed data (active constraints),
    one problem and a batch of three solved in one call."""
    A = rng.normal(size=(3, 30, 5)).astype(np.float32)
    B = rng.normal(size=(3, 30, 4)).astype(np.float32)
    batched = nnls(t(A), t(B), iters).numpy()
    for b in range(3):
        want = jnnls.nnls(jnp.asarray(A[b]), jnp.asarray(B[b]), iters)
        close(nnls(t(A[b]), t(B[b]), iters).numpy(), want)
        close(batched[b], want)
        AtA, AtB = A[b].T @ A[b], A[b].T @ B[b]
        close(nnls_gram(t(AtA), t(AtB), iters).numpy(),
              jnnls.nnls_gram(jnp.asarray(AtA), jnp.asarray(AtB), iters))
    rows = B[0].T                                     # [K=4, M=30]
    close(nnls_rows(t(A[0]), t(rows), iters).numpy(),
          jnnls.nnls_rows(jnp.asarray(A[0]), jnp.asarray(rows), iters))
    assert (batched >= 0).all()


def test_column_sum_normalize_matches(rng):
    X = rng.uniform(size=(12, 7)).astype(np.float32)
    X[:, 3] = 0.0                                     # a zero column
    got, s = column_sum_normalize(t(X))
    want, ws = jspa.column_sum_normalize(jnp.asarray(X))
    close(got.numpy(), want)
    close(s.numpy(), ws)


def test_spa_matches_and_ties_take_the_first(rng):
    """SPA's columns equal JAX's, one problem and batched; among equal
    column norms both take the first, problem by problem."""
    T = rng.uniform(size=(3, 16, 40)).astype(np.float32)
    T[1, :, 7] = T[1, :, 2]                         # tie, first is column 2
    T[1, :, 2] *= 5.0
    T[1, :, 7] *= 5.0
    idx_b = spa_indices(t(T), 4).numpy()
    for b in range(3):
        want = np.asarray(jspa.spa_indices(jnp.asarray(T[b]), 4))
        np.testing.assert_array_equal(spa_indices(t(T[b]), 4).numpy(), want)
        np.testing.assert_array_equal(idx_b[b], want)
    assert idx_b[1, 0] == 2
    C_b, S_b = nmf_spa(t(T.transpose(0, 2, 1)), 3)
    for b in range(3):
        C, S = jspa.nmf_spa(jnp.asarray(T[b].T), 3)
        close(C_b[b].numpy(), C)
        close(S_b[b].numpy(), S)


def test_tps_matches(rng):
    """TPS completion, one map and a batch of two (its own samples each)."""
    K, I, J, N = 4, 15, 13, 24
    T = rng.uniform(size=(2, K, I, J)).astype(np.float32)
    idx = np.stack([np.stack(np.unravel_index(
        rng.choice(I * J, N, replace=False), (I, J)), 1) for _ in range(2)])
    batched = tps_complete(t(T), None, t(idx)).numpy()
    for b in range(2):
        want = jtps.tps_complete(jnp.asarray(T[b]), None, jnp.asarray(idx[b]))
        close(tps_complete(t(T[b]), None, t(idx[b])).numpy(), want,
              rtol=0.0, atol_rel=1e-3)
        close(batched[b], want, rtol=0.0, atol_rel=1e-3)
        # it interpolates: the samples come back
        got = batched[b][:, idx[b][:, 0], idx[b][:, 1]]
        np.testing.assert_allclose(got, T[b][:, idx[b][:, 0], idx[b][:, 1]],
                                   atol=1e-3)


def test_ridge_solve_matches(rng):
    G = rng.normal(size=(5, 6, 6)).astype(np.float32)
    G = G @ G.transpose(0, 2, 1)
    G[2] = 0.0                                        # an all-zero row block
    rhs = rng.normal(size=(5, 6)).astype(np.float32)
    want = jax.vmap(lambda g, r: jbtd._ridge_solve(g, r, 1e-3))(
        jnp.asarray(G), jnp.asarray(rhs))
    close(_ridge_solve(t(G), t(rhs), 1e-3).numpy(), want)


def jax_btd_draws(key, restarts, R, I, J, K, L):
    """JAX btd_ll1's standard normals for its `restarts` starts."""
    keys = [key] if restarts == 1 else list(jax.random.split(key, restarts))
    out = [[], [], []]
    for k in keys:
        ka, kb, kc = jax.random.split(k, 3)
        for i, x in enumerate((jax.random.normal(ka, (R, I, L)),
                               jax.random.normal(kb, (R, J, L)),
                               jax.random.normal(kc, (R, K)))):
            out[i].append(np.asarray(x))
    return [np.stack(x) for x in out]


@pytest.mark.parametrize("restarts,observed,tol", [
    (1, 0.7, 1e-4), (3, 0.7, 1e-4), (3, 1.0, 1e-4), (1, 0.4, 5e-3)])
def test_btd_matches(rng, restarts, observed, tol):
    """btd_ll1 at cut depth (6 ALS sweeps): factors, T_hat and the restart
    winner equal JAX's (the winner by the same factors); observed 1.0 is
    the unmasked fit."""
    K, I, J, R, L = 6, 9, 7, 2, 3
    T = rng.uniform(size=(K, I, J)).astype(np.float32)
    M = (rng.uniform(size=(K, I, J)) < observed).astype(np.float32)
    masked = observed < 1.0
    key = jax.random.PRNGKey(4)
    want = jbtd.btd_ll1(jnp.asarray(T), R, L, iters=6,
                        mask=jnp.asarray(M) if masked else None, key=key,
                        restarts=restarts)
    draws = [t(x) for x in jax_btd_draws(key, restarts, R, I, J, K, L)]
    got = btd_ll1(t(T), R, L, iters=6, mask=t(M) if masked else None,
                  restarts=restarts, draws=draws)
    for name, a, b in zip(("S", "C", "T_hat"), got, want):
        close(a.numpy(), b, atol_rel=tol, err_msg=name)
    # batched: two problems, their own starts, one call
    draws2 = [torch.stack([x, x.flip(0)]) for x in draws]
    Tb = torch.stack([t(T), t(T[::-1].copy())])
    Mb = torch.stack([t(M), t(M)]) if masked else None
    S2, C2, T2 = btd_ll1(Tb, R, L, iters=6, mask=Mb, restarts=restarts,
                         draws=draws2)
    close(T2[0].numpy(), want[2], atol_rel=tol)
    alone = btd_ll1(Tb[1], R, L, iters=6, mask=Mb[1] if masked else None,
                    restarts=restarts, draws=[x[1] for x in draws2])
    close(T2[1].numpy(), alone[2].numpy(), atol_rel=tol)


def test_btd_draws_from_generator():
    """Without draws the starts come from the generator: same seed, same
    fit; the masked residual falls with more sweeps."""
    rng = np.random.default_rng(1)
    T = t(rng.uniform(size=(5, 8, 8)).astype(np.float32))

    def fit(iters, seed=0):
        g = torch.Generator().manual_seed(seed)
        return btd_ll1(T, 2, 2, iters=iters, generator=g, restarts=2)[2]

    torch.testing.assert_close(fit(4), fit(4), rtol=0, atol=0)
    assert ((fit(12) - T).square().sum() < (fit(1) - T).square().sum())


def test_best_permutation_is_globally_optimal(rng):
    for R in (2, 4, 6):
        S_hat = rng.random((R, 9)) + 0.01
        S_true = rng.random((R, 9)) + 0.01
        A = S_hat / np.linalg.norm(S_hat, axis=1, keepdims=True)
        B = S_true / np.linalg.norm(S_true, axis=1, keepdims=True)
        corr = A @ B.T
        best = max(sum(corr[p[j], j] for j in range(R))
                   for p in itertools.permutations(range(R)))
        got = best_permutation(t(S_hat), t(S_true))
        assert np.isclose(sum(corr[got[j], j] for j in range(R)), best)
        np.testing.assert_array_equal(
            got, np.asarray(jax_best_permutation(jnp.asarray(S_hat),
                                                 jnp.asarray(S_true))))


def test_best_permutation_greedy_trap():
    """Greedy takes hat0 -> true0 (0.99) and is left with 0.1; the optimum
    is the cross 0.9 + 0.95, as JAX finds it."""
    e = np.eye(3)
    S_true = np.stack([e[0], e[1]])
    S_hat = np.stack([0.99 * e[0] + 0.9 * e[1] + 0.2 * e[2],
                      0.95 * e[0] + 0.1 * e[1] + 0.2 * e[2]])
    A = S_hat / np.linalg.norm(S_hat, axis=1, keepdims=True)
    corr = A @ S_true.T
    perm = best_permutation(t(S_hat), t(S_true))
    assert corr[perm[0], 0] + corr[perm[1], 1] == max(
        corr[0, 0] + corr[1, 1], corr[1, 0] + corr[0, 1])
    np.testing.assert_array_equal(perm, [1, 0])
    np.testing.assert_array_equal(
        perm, np.asarray(jax_best_permutation(jnp.asarray(S_hat),
                                              jnp.asarray(S_true))))
