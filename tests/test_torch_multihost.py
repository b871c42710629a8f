"""The port's multi-process paths on the CPU: real OS processes joined by
torch.distributed with gloo and a file:// rendezvous under tmp_path (so
that parallel test workers never contend for a TCP port).

- the K-sharded solve and one sharded gradient step with K split over
  'model' in 2 processes, against the same calls in this process with no
  process group;
- `multihost_launch.py` (`multihost_recover_lowrank`, the batch split over
  'data'): 2 processes against 1, and the --shard-dir path through the
  native loader against the regenerate path, bit for bit.

Every subprocess has its own timeout of 120 s."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from quantized_spectrum_cartography_tpu_torch.config import (
    QuantizerConfig,
    SolverConfig,
)
from quantized_spectrum_cartography_tpu_torch.ops import boundaries as B
from quantized_spectrum_cartography_tpu_torch.ops.likelihood import (
    gather_bin_bounds,
)
from quantized_spectrum_cartography_tpu_torch.ops.quantizer import (
    quantize_log,
)
from quantized_spectrum_cartography_tpu_torch.parallel import (
    make_mesh,
    make_sharded_mle_step,
    recover_lowrank_mle_ksharded,
)

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120
# each process takes 2 threads at most, beside the other test workers
ENV = dict(os.environ, OMP_NUM_THREADS="2")

Bn, R, K, G = 2, 2, 16, 16
SOLVER = dict(max_iters=12, lr_s=0.003, projection_interval=4,
              rank_truncation=6)
QUANT = QuantizerConfig(boundaries=B.QUANTIZATION_BOUNDARIES_4_BINS_LOG,
                        noise_std=5.0, log_offset=B.LOG_OFFSET_4)

# One rank of the K-sharded run: mesh (1, world), K over 'model'.
KSHARD_RANK = """
import sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, {tests!r})
import test_torch_multihost as T
from quantized_spectrum_cartography_tpu_torch.config import SolverConfig
from quantized_spectrum_cartography_tpu_torch.parallel import (
    init_distributed, local_batch_to_global, make_global_mesh,
    make_sharded_mle_step, process_local_slice, recover_lowrank_mle_ksharded)
rank, world = {rank}, {world}
torch.set_num_threads(1)
init_distributed({rdv!r}, world, rank, "cpu")
# the batch over 'data': rank r feeds r + 2 rows of 3 x 4
data = make_global_mesh()
rows = local_batch_to_global(data, np.zeros((rank + 2, 3, 4), np.float32),
                             device="cpu")
try:
    local_batch_to_global(data, np.zeros((2, 3 + rank, 4), np.float32),
                          device="cpu")
    mismatch = "accepted"
except ValueError:
    mismatch = "rejected"
mesh = make_global_mesh((1, world))
d = {{k: torch.from_numpy(v) for k, v in np.load({inputs!r}).items()}}
S, C, costs = recover_lowrank_mle_ksharded(
    mesh, d["W"], d["U"], d["S0"], d["C0"], SolverConfig(**T.SOLVER),
    T.QUANT, probe=d["probe"])
S1, C1, nll = make_sharded_mle_step(mesh, SolverConfig(), T.QUANT)(
    d["S"], d["C"], d["W"], d["U"])
np.savez({out!r}, S=S, C=C, costs=costs, S1=S1, C1=C1, nll=nll,
         data_shape=data.shape, start=rows.start,
         global_shape=rows.global_shape, mismatch=mismatch,
         local_slice=process_local_slice(8, data))
dist.destroy_process_group()
"""


def _inputs():
    rng = np.random.default_rng(3)
    IJ = G * G
    S = torch.from_numpy(rng.uniform(0, 0.05, (Bn, R, IJ)).astype(np.float32))
    C = torch.from_numpy(rng.uniform(0, 1, (Bn, R, K)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((Bn, K, IJ)).astype(
        np.float32))
    Y = quantize_log(torch.einsum("brp,brk->bkp", S, C), 0.5, QUANT.boundaries,
                     QUANT.log_offset, noise=noise)
    W, U = gather_bin_bounds(Y, QUANT.boundaries)
    probe = torch.from_numpy(rng.standard_normal((G, 6 + 8)).astype(
        np.float32))
    return {"W": W, "U": U, "S0": torch.zeros(Bn, R, IJ),
            "C0": torch.full((Bn, R, K), 0.01), "probe": probe, "S": S,
            "C": C}


@pytest.fixture(scope="module")
def ksharded(tmp_path_factory):
    """(this process's results, each of the 2 ranks' results)."""
    tmp = tmp_path_factory.mktemp("ksharded")
    d = _inputs()
    np.savez(tmp / "inputs.npz", **{k: v.numpy() for k, v in d.items()})
    procs = [subprocess.Popen(
        [sys.executable, "-c", KSHARD_RANK.format(
            tests=str(REPO / "tests"), rank=r, world=2,
            rdv=f"file://{tmp}/rendezvous", inputs=str(tmp / "inputs.npz"),
            out=str(tmp / f"rank{r}.npz"))],
        cwd=REPO, env=ENV, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    mesh = make_mesh()
    S, C, costs = recover_lowrank_mle_ksharded(
        mesh, d["W"], d["U"], d["S0"], d["C0"], SolverConfig(**SOLVER), QUANT,
        probe=d["probe"])
    S1, C1, nll = make_sharded_mle_step(mesh, SolverConfig(), QUANT)(
        d["S"], d["C"], d["W"], d["U"])
    one = dict(S=S, C=C, costs=costs, S1=S1, C1=C1, nll=nll)
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]
    return {k: v.numpy() for k, v in one.items()}, ranks


def test_ksharded_two_processes_match_one(ksharded):
    """K split over 2 ranks: each holds its half of C and the replicated S
    and costs.  The ranks agree with each other bit for bit; against one
    process at the JAX test's tolerances (costs rtol 2e-4, factors rtol
    1e-3, atol 1e-6): summing dS over two halves of K rounds otherwise
    than one sum over all of K."""
    one, ranks = ksharded
    halves = np.split(one["C"], 2, axis=2)
    for r, got in enumerate(ranks):
        assert got["C"].shape == halves[r].shape
        np.testing.assert_allclose(got["costs"], one["costs"], rtol=2e-4)
        np.testing.assert_allclose(got["S"], one["S"], rtol=1e-3, atol=1e-6)
        np.testing.assert_allclose(got["C"], halves[r], rtol=1e-3, atol=1e-6)
    for key in ("S", "costs"):
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
    assert one["costs"][:, -1].mean() < one["costs"][:, 0].mean()


def test_global_batch_from_local_slices(ksharded):
    """local_batch_to_global over 2 'data' ranks feeding 2 and 3 rows:
    each rank's offset and the global shape; slices whose other
    dimensions differ are rejected on every rank."""
    _, ranks = ksharded
    for r, got in enumerate(ranks):
        assert tuple(got["data_shape"]) == (2, 1)
        assert int(got["start"]) == 2 * r
        assert tuple(got["global_shape"]) == (5, 3, 4)
        assert str(got["mismatch"]) == "rejected"
        assert tuple(got["local_slice"]) == (4 * r, 4 * r + 4)


def test_sharded_step_two_processes_match_one(ksharded):
    """One gradient step with K split over 2 ranks: nll rtol 1e-4, S and C
    rtol 1e-4, atol 1e-7 (tests/test_parallel.py's tolerances)."""
    one, ranks = ksharded
    halves = np.split(one["C1"], 2, axis=2)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["nll"], one["nll"], rtol=1e-4)
        np.testing.assert_allclose(got["S1"], one["S1"], rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(got["C1"], halves[r], rtol=1e-4,
                                   atol=1e-7)


def _launch(tmp, name, num_processes, shard_dir=None):
    out = tmp / f"{name}.json"
    cmd = [sys.executable, "-m",
           "quantized_spectrum_cartography_tpu_torch.multihost_launch",
           "--device", "cpu", "--num-processes", str(num_processes),
           "--global-batch", "4", "--iters", "3", "--reps", "0",
           "--init-method", f"file://{tmp}/{name}.rendezvous",
           "--timeout", str(TIMEOUT_S - 20), "--out", str(out)]
    if shard_dir:
        cmd += ["--shard-dir", str(shard_dir)]
    return subprocess.Popen(cmd, cwd=REPO, env=ENV, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True), out


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """The three launches, run side by side."""
    tmp = tmp_path_factory.mktemp("multihost")
    runs = {"regen1": _launch(tmp, "regen1", 1),
            "regen2": _launch(tmp, "regen2", 2),
            "shard2": _launch(tmp, "shard2", 2, tmp / "shards")}
    try:
        for name, (p, _) in runs.items():
            _, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, f"{name}: {err[-3000:]}"
    finally:
        for p, _ in runs.values():
            if p.poll() is None:
                p.kill()
    summaries = {name: json.loads(out.read_text())
                 for name, (_, out) in runs.items()}
    summaries["shard_dir"] = tmp / "shards"
    return summaries


def test_two_process_recovery_matches_single_process(launches):
    one, two = launches["regen1"], launches["regen2"]
    # every process reported the identical global cost
    assert len({r["global_cost"] for r in two["per_process"]}) == 1
    assert [r["rows"] for r in two["per_process"]] == [[0, 2], [2, 4]]
    assert all(r["world_size"] == 2 for r in two["per_process"])
    # distribution changes nothing: bit-identical final costs per map
    assert one["global_cost"] == two["global_cost"]
    assert one["global_costs_tail"] == two["global_costs_tail"]
    assert np.isfinite(one["global_costs_tail"]).all()


def test_shard_data_path_bit_identity(launches):
    """Per-rank native shards (each worker reads only its own) against the
    regenerate path: the same rows, so the same results bit for bit; each
    shard holds exactly its rank's rows."""
    shard, regen = launches["shard2"], launches["regen2"]
    assert shard["data_path"] == "native_shard"
    assert regen["data_path"] == "regenerate"
    item_bytes = 64 * 51 * 51 * 4
    for pid in range(2):
        assert os.path.getsize(launches["shard_dir"] / f"shard_{pid}.f32") \
            == 2 * item_bytes
    for a, b in zip(shard["per_process"], regen["per_process"]):
        assert a["local_sha256"] == b["local_sha256"]
    assert shard["global_cost"] == regen["global_cost"]
    assert shard["global_costs_tail"] == regen["global_costs_tail"]
