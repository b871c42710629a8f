"""The port's `.mat` fixture loader against the JAX package's on a file
in the reference's MATLAB layouts (written with `scipy.io.savemat`: the
reference's own `onebitdata1.mat` is not in the repository), the
FileNotFoundError of both on a missing path, and `recover --fixture` of the
port's CLI."""

import json

import numpy as np
import pytest
import scipy.io as sio

from quantized_spectrum_cartography_tpu.data import fixtures as jfix
from quantized_spectrum_cartography_tpu_torch import cli
from quantized_spectrum_cartography_tpu_torch.data import fixtures as tfix

I, J, K, R = 51, 51, 16, 2


def write_fixture(path, seed=0):
    """A fixture in MATLAB layouts: T (I,J,K) +-1, T_true (I,J,K), S_true
    (I,J,R), C_true (K,R), Om (I,J) (generate_test_data.m:78-80)."""
    rng = np.random.default_rng(seed)
    S = rng.uniform(size=(I, J, R)) * 0.01
    C = rng.uniform(size=(K, R))
    T_true = np.einsum("ijr,kr->ijk", S, C)
    sio.savemat(path, {"T": np.where(T_true > 0.0045, 1.0, -1.0),
                       "T_true": T_true, "S_true": S, "C_true": C,
                       "Om": (rng.uniform(size=(I, J)) < 0.1).astype(
                           np.uint8)})
    return T_true, S, C


@pytest.fixture
def mat(tmp_path):
    path = str(tmp_path / "onebit.mat")
    return path, write_fixture(path)


def test_loaders_agree(mat):
    path, (T_true, S, C) = mat
    ref = jfix.load_onebit_fixture(path)
    got = tfix.load_onebit_fixture(path, device="cpu")
    for name in ("T_true", "S_true", "C_true", "T_1bit", "Om"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.shape == ref.shape == (R, I, J, K)
    assert got.mean_slf == ref.mean_slf and got.peaks is None
    np.testing.assert_array_equal(got.T_true.numpy(),
                                  np.transpose(T_true, (2, 0, 1)).astype(
                                      np.float32))
    np.testing.assert_array_equal(got.C_true.numpy(), C.T.astype(np.float32))


def test_missing_fixture_raises(tmp_path):
    path = str(tmp_path / "absent.mat")
    with pytest.raises(FileNotFoundError) as jerr:
        jfix.load_onebit_fixture(path)
    with pytest.raises(FileNotFoundError) as terr:
        tfix.load_onebit_fixture(path, device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert tfix.REFERENCE_FIXTURE == jfix.REFERENCE_FIXTURE


def test_cli_recover_fixture(mat, capsys):
    """`recover --fixture --solver lowrank` runs the low-rank solver on the
    file's map and prints its JSON line."""
    path, _ = mat
    cli.main(["recover", "--fixture", path, "--solver", "lowrank",
              "--iters", "2", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["solver"] == "lowrank" and out["iters"] == 2
    assert np.isfinite(out["final_cost"]) and np.isfinite(out["final_nmse"])
