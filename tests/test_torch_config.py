"""The port's config dataclasses are copies of the JAX package's: same
field names, same defaults; its config-file loader reads INI and JSON files
as the JAX package's does; `recover --config` runs on them."""

import dataclasses
import json

import pytest
import torch

from quantized_spectrum_cartography_tpu import config as jax_config
from quantized_spectrum_cartography_tpu_torch import config as torch_config
from quantized_spectrum_cartography_tpu_torch.cli import main as cli_main

torch.set_num_threads(1)


def _default(f):
    if f.default_factory is not dataclasses.MISSING:
        return dataclasses.asdict(f.default_factory())
    return f.default


@pytest.mark.parametrize("name", ["PhysicsConfig", "QuantizerConfig",
                                  "SolverConfig", "MeshConfig",
                                  "ProblemConfig"])
def test_fields_and_defaults_match(name):
    ref = [(f.name, _default(f)) for f in
           dataclasses.fields(getattr(jax_config, name))]
    got = [(f.name, _default(f)) for f in
           dataclasses.fields(getattr(torch_config, name))]
    assert got == ref


def test_quantizer_num_bins():
    bb = (-1.0, 0.0, 1.0, 2.0)
    assert (torch_config.QuantizerConfig(boundaries=bb).num_bins
            == jax_config.QuantizerConfig(boundaries=bb).num_bins == 3)


INI = """
[general]
seed = 3
[physics]
num_emitters = 3
separable = false
psd_basis = s
[quantizer]
boundaries = -23.025850296020508, -10.002398490905762, -7.980128765106201, -6.692554473876953, -1.0331487655639648
noise_std = 5.0
[solver]
max_iters = 2
z_search_global = 4
z_search_local = 4
sample_fraction = 0.2
[mesh]
axis_names = batch freq
"""

JSON = {"seed": 5,
        "physics": {"grid_size": 51, "shadow_sigma": 6.0},
        "quantizer": {"boundaries": [-23.025850296020508, -10.002398490905762,
                                     -7.980128765106201, -6.692554473876953,
                                     -1.0331487655639648]},
        "solver": {"max_iters": 2, "z_search_global": 4,
                   "z_search_local": 4, "nonneg_slf": True},
        "mesh": {"model_axis": 2}}


@pytest.fixture(params=["ini", "json"])
def config_file(request, tmp_path):
    path = tmp_path / f"run.{request.param}"
    path.write_text(INI if request.param == "ini" else json.dumps(JSON))
    return str(path)


def test_load_config_file_matches(config_file):
    got = torch_config.load_config_file(config_file)
    ref = jax_config.load_config_file(config_file)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.seed in (3, 5) and got.solver.max_iters == 2


def test_load_config_file_rejects_unknown(tmp_path):
    path = tmp_path / "bad.ini"
    path.write_text("[solver]\nmax_iter = 3\n")
    with pytest.raises(ValueError, match="max_iter"):
        torch_config.load_config_file(str(path))
    path.write_text("[solvers]\nmax_iters = 3\n")
    with pytest.raises(ValueError, match="solvers"):
        torch_config.load_config_file(str(path))
    with pytest.raises(FileNotFoundError):
        torch_config.load_config_file(str(tmp_path / "none.ini"))


def test_cli_recover_config(config_file, capsys):
    """`recover --solver mle-gan --config` on the CPU: the file's solver
    settings (2 iterations) and seed take effect; one-line JSON."""
    cli_main(["recover", "--solver", "mle-gan", "--config", config_file,
              "--device", "cpu"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["solver"] == "mle-gan" and res["iters"] == 2
    assert res["final_cost"] > 0 and res["final_nmse"] > 0


def test_set_card_numerics_turns_tf32_off():
    """The card's numerics, which cli.main sets for a CUDA device: no TF32
    in matmuls or cuDNN, deterministic cuDNN without benchmarking.  The
    process-wide flags are restored afterwards."""
    from quantized_spectrum_cartography_tpu_torch.config import (
        set_card_numerics,
    )

    flags = (torch.backends.cuda.matmul, "allow_tf32"), \
        (torch.backends.cudnn, "allow_tf32"), \
        (torch.backends.cudnn, "deterministic"), \
        (torch.backends.cudnn, "benchmark")
    saved = [getattr(o, name) for o, name in flags]
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cudnn.benchmark = True
        set_card_numerics()
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.deterministic is True
        assert torch.backends.cudnn.benchmark is False
    finally:
        for (o, name), value in zip(flags, saved):
            setattr(o, name, value)
