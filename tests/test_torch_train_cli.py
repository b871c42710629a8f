"""``cli train-prior`` of the port for each kind on the CPU, and ``recover``
on the GAN and VAE checkpoints it wrote; no fallback to the CPU."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from quantized_spectrum_cartography_tpu_torch import cli
from quantized_spectrum_cartography_tpu_torch.training import ae_trainer as tae
from quantized_spectrum_cartography_tpu_torch.training.checkpoints import (
    load_checkpoint,
)

torch.set_num_threads(1)


def run_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return out.getvalue().strip().splitlines()


@pytest.mark.parametrize("kind", ["gan", "ae", "vae", "aae"])
def test_cli_train_prior_writes_what_recover_reads(kind, tmp_path):
    """train-prior --steps 2 --batch 2 on the CPU at the JAX configuration
    of each kind; the GAN and VAE checkpoints drive recover --solver
    mle-gan, the AE's load_ae, the AAE's carries its config."""
    ckpt = str(tmp_path / kind)
    lines = run_cli(["train-prior", "--kind", kind, "--steps", "2",
                     "--batch", "2", "--device", "cpu", "--checkpoint-dir",
                     ckpt, "--log-every", "1"] + (
                         ["--z-dim", "64"] if kind == "aae" else []))
    summary = json.loads(lines[-1])
    assert summary["kind"] == kind and summary["steps"] == 2
    assert len(summary["log"]) == 2 and summary["steps_per_s"] > 0
    if kind in ("gan", "vae"):
        out = json.loads(run_cli(
            ["recover", "--solver", "mle-gan", "--prior-kind", kind,
             "--prior-checkpoint", f"{ckpt}/final", "--iters", "2",
             "--device", "cpu"])[-1])
        assert out["iters"] == 2
        assert np.isfinite(out["final_cost"]) and np.isfinite(
            out["final_nmse"])
    elif kind == "ae":
        model, scale = tae.load_ae(f"{ckpt}/final")
        assert scale == tae.AETrainConfig().scale
    else:
        tree = load_checkpoint(ckpt)
        assert tree["config"]["z_dim"] == 64
        assert tree["config"]["batch_size"] == 2
        assert sorted(tree) == ["config", "dec", "dec_stats", "dz", "enc",
                                "enc_stats"]


def test_cli_cuda_without_a_card_fails():
    """No fallback: --device cuda with no card exits before any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["train-prior", "--kind", "gan", "--steps", "1"])
