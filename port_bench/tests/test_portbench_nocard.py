"""Without a card the run fails and prints no result; so it does in a
directory that holds only BENCHMARK.json and the benchmark's folder."""

import shutil
import subprocess
import sys

import pytest
import torch

from port_bench import harness

ARGS = ["-m", "port_bench.run", "--workload", "lowrank-1bit-r2.batch256",
        "--seed", str(2 ** 31 + 77), "--seconds", "1", "--trace", "0"]


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def run_in(cwd):
    return subprocess.run([sys.executable, *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result(no_card):
    out = run_in(harness.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_in(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
