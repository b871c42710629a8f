"""`cli report` of the port writes the JAX CLI's six figures from a
`recover --out` npz, and `utils.profiling` times calls and writes a
trace."""

import json
import os

from quantized_spectrum_cartography_tpu import cli as jcli
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
