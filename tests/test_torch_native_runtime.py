"""The port's native C++ runtime (`runtime/`): built from its own copy of
the source at first use; the cases of tests/test_native_runtime.py, and the
shard format held against the JAX package's `write_shard`."""

import os
import threading

import numpy as np
import pytest

from quantized_spectrum_cartography_tpu.runtime.native import (
    write_shard as jax_write_shard,
)
from quantized_spectrum_cartography_tpu_torch.runtime import (
    NativeBatchQueue,
    NativeShardLoader,
    build_runtime,
    native_available,
    write_shard,
)
from quantized_spectrum_cartography_tpu_torch.runtime import native


def test_build_produces_so():
    """The library is built from the port's source under build/, named by
    its hash, and never the JAX package's committed .so."""
    so = build_runtime()
    assert os.path.exists(so)
    assert native_available()
    assert os.path.dirname(so) == str(native.BUILD_DIR)
    assert os.path.basename(so).startswith("libqsc_runtime_")
    assert "quantized_spectrum_cartography_tpu/" not in so


def test_queue_roundtrip_and_batching():
    item = np.arange(12, dtype=np.float32)
    q = NativeBatchQueue(capacity=64, item_bytes=item.nbytes)
    for i in range(10):
        assert q.push(item + i)
    out = q.pop_batch(max_items=4)
    assert out.shape[0] == 4
    np.testing.assert_array_equal(np.frombuffer(out[0].tobytes(), np.float32),
                                  item)
    np.testing.assert_array_equal(np.frombuffer(out[3].tobytes(), np.float32),
                                  item + 3)
    assert q.pushed == 10
    assert q.popped == 4
    with pytest.raises(ValueError):
        q.push(np.zeros(3, np.float32))
    q.close()
    assert not q.push(item)          # closed


def test_queue_timeout_on_empty():
    q = NativeBatchQueue(capacity=4, item_bytes=8)
    out = q.pop_batch(max_items=2, timeout_ms=50)
    assert out.shape[0] == 0
    q.close()


def test_queue_concurrent_producers():
    item_bytes = 16
    q = NativeBatchQueue(capacity=1024, item_bytes=item_bytes)

    def produce(tid):
        x = np.full(4, tid, np.float32)
        for _ in range(50):
            q.push(x)

    threads = [threading.Thread(target=produce, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    got = []
    while sum(len(g) for g in got) < 200:
        got.append(q.pop_batch(max_items=32, timeout_ms=2000))
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    vals = np.frombuffer(np.concatenate(got).tobytes(), np.float32)
    # every producer's 50 payloads arrived whole
    assert sorted(np.bincount(vals.reshape(-1, 4)[:, 0].astype(int))) == [50] * 4


def test_shard_loader_samples_real_items(tmp_path):
    N, I, J = 32, 7, 5
    maps = np.random.default_rng(0).normal(size=(N, I, J)).astype(np.float32)
    path = os.path.join(str(tmp_path), "shard.f32")
    write_shard(path, maps)
    loader = NativeShardLoader(path, (I, J), batch=8, num_threads=2, seed=1)
    assert len(loader) == N
    flat = maps.reshape(N, -1)
    for _ in range(5):
        batch = loader.next_batch(timeout_ms=5000)
        assert batch.shape == (8, I, J)
        for row in batch.reshape(8, -1):
            # every sampled row is an actual dataset item, bit for bit
            assert np.any(np.all(flat == row[None], axis=1))
    assert loader.batches_served == 5
    loader.close()


def test_shard_loader_rejects_bad_size(tmp_path):
    path = os.path.join(str(tmp_path), "bad.f32")
    np.ones(7, np.float32).tofile(path)
    with pytest.raises(OSError):
        NativeShardLoader(path, (2, 2), batch=2)
    with pytest.raises(OSError):
        NativeShardLoader(os.path.join(str(tmp_path), "missing.f32"), (2, 2),
                          batch=2)


def test_shard_matches_jax_package(tmp_path):
    """The port's shard file is byte-equal to the JAX package's for the same
    maps (float64 input, cast on write), and the ordered read returns the
    same rows, short at the end of the shard."""
    maps = np.random.default_rng(1).uniform(size=(6, 3, 4, 5))
    ours, theirs = tmp_path / "port.f32", tmp_path / "jax.f32"
    write_shard(str(ours), maps)
    jax_write_shard(str(theirs), maps)
    assert ours.read_bytes() == theirs.read_bytes()
    loader = NativeShardLoader(str(theirs), (3, 4, 5), batch=2,
                               num_threads=0)
    np.testing.assert_array_equal(loader.read(1, 3),
                                  maps[1:4].astype(np.float32))
    assert loader.read(4, 10).shape == (2, 3, 4, 5)
    assert loader.read(6, 1).shape == (0, 3, 4, 5)
    loader.close()
