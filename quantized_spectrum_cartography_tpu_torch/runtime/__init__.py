from quantized_spectrum_cartography_tpu_torch.runtime.native import (  # noqa: F401
    NativeBatchQueue,
    NativeShardLoader,
    build_runtime,
    native_available,
    write_shard,
)
