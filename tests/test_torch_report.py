"""`cli report` of the port writes the JAX CLI's six figures from a
`recover --out` npz, and `utils.profiling.likelihood_roofline` keeps JAX's
byte and FLOP model (against the H100's peaks)."""

import json
import os

import pytest

from quantized_spectrum_cartography_tpu import cli as jcli
from quantized_spectrum_cartography_tpu.utils import profiling as jprof
from quantized_spectrum_cartography_tpu_torch import cli
from quantized_spectrum_cartography_tpu_torch.utils import profiling



def test_report_writes_jax_figures(tmp_path, capsys):
    rec = str(tmp_path / "rec.npz")
    cli.main(["recover", "--solver", "lowrank", "--iters", "2",
              "--device", "cpu", "--out", rec])
    capsys.readouterr()
    cli.main(["report", "--recovery", rec, "--out-dir",
              str(tmp_path / "port"), "--dpi", "40"])
    written = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jcli.main(["report", "--recovery", rec, "--out-dir",
               str(tmp_path / "jax"), "--dpi", "40"])
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 6
    assert sorted(map(os.path.basename, written["written"])) == names
    for name in names:
        assert os.path.getsize(tmp_path / "port" / name) > 0


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("shape", [(256, 64, 2688, 2), (1, 64, 2688, 10)])
def test_likelihood_roofline_model(shape, backward):
    """The same bytes, FLOPs and achieved rates as JAX's for the same
    arguments; the shares are of the H100's 3.35 TB/s and 67 TFLOP/s."""
    us = 123.0
    ref = jprof.likelihood_roofline(*shape, us, backward=backward)
    got = profiling.likelihood_roofline(*shape, us, backward=backward)
    assert got["achieved_GBps"] == ref["achieved_GBps"]
    assert got["achieved_TFLOPs"] == ref["achieved_TFLOPs"]
    assert got["bytes"] == pytest.approx(ref["achieved_GBps"] * us * 1e3)
    assert got["flops"] == pytest.approx(ref["achieved_TFLOPs"] * us * 1e6)
    assert got["pct_hbm_peak"] == pytest.approx(
        100 * got["achieved_GBps"] / 3350.0)
    assert got["pct_f32_peak"] == pytest.approx(
        100 * got["achieved_TFLOPs"] / 67.0)
    assert got["bound"] == ("bandwidth" if got["pct_hbm_peak"]
                            > got["pct_f32_peak"] else "compute")


def test_time_calls_and_trace(tmp_path):
    """The first call apart from the steady ones; a Chrome trace written."""
    import torch

    calls = []
    timed = profiling.time_calls(lambda x: calls.append(x.sum()),
                                 torch.ones(4), iters=3)
    assert len(calls) == 4
    assert timed["first_call_s"] >= 0 and timed["per_call_us"] >= 0
    path = tmp_path / "t" / "trace.json"
    with profiling.trace(str(path)):
        torch.ones(8).sum()
    assert "traceEvents" in json.loads(path.read_text())
