"""The priors' weights: checkpoints read and written without orbax, and flax
parameter trees mapped onto the port's modules and back.

`load_checkpoint` reads two layouts:

- a checkpoint directory that the JAX package wrote
  (``training/checkpoints.py:save_checkpoint``, orbax's standard layout):
  the tree paths from ``_METADATA``, each array as zarr v2 chunks
  (``.zarray`` metadata and zstd-compressed chunks) in the OCDBT store of
  `training.ocdbt`.  It returns the nested dict of numpy arrays that the
  JAX package's ``load_checkpoint(path)`` returns, with the same keys,
  dtypes, shapes and bits; scalars are 0-d arrays there and here;
- a directory that this package's `save_checkpoint` wrote: ``arrays.npz``,
  the array leaves under their "/"-joined paths, and ``leaves.json``, the
  other leaves (numbers, strings, an AAE's ``config``) under theirs.  The
  trees the port's trainers save are in flax's layout (flax's names, HWIO
  kernels), so the loaders read a prior trained here as one trained by the
  JAX package.

A flax parameter tree ({"params": ..., "batch_stats": ...,
["spectral_stats": ...]}) becomes a torch state_dict (`state_dict_from_flax`;
`flax_from_state_dict` is its inverse):

- ``ConvTranspose`` kernels [kh, kw, in, out] become torch's
  [in, out, kh, kw], flipped in both spatial axes: flax applies the kernel
  unflipped to the dilated input, torch's transpose convolution flips it;
- ``Conv`` and ``SNConv`` kernels [kh, kw, in, out] become [out, in, kh,
  kw], unflipped; a spectral norm's ``spectral_stats`` vector ``u`` becomes
  the layer's buffer ``u``;
- ``Dense`` kernels [in, out] become Linear weights [out, in];
- BatchNorm ``scale``/``bias`` and ``batch_stats`` ``mean``/``var`` become
  ``weight``/``bias``/``running_mean``/``running_var``;
- ``scale``, where a generator's tree has one, is the output divisor that
  the CLI applies to the generator (JAX ``cli.py:_load_prior``).
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from quantized_spectrum_cartography_tpu_torch.models.generator import (
    DCGANGenerator,
    make_generator,
)
from quantized_spectrum_cartography_tpu_torch.training.ocdbt import (
    FormatError,
    OcdbtReader,
    unzstd,
)

_VALUE_TYPES = ("jax.Array", "scalar")
# per-leaf digests of the repository's trained trees as the JAX package's
# loader returns them (held against it by tests/test_torch_checkpoints.py)
DIGESTS = Path(__file__).with_name("checkpoint_digests.json")
_DICT_KEY = 2          # orbax's key_type of a dict key


def _zarr_array(store: OcdbtReader, name: str) -> np.ndarray:
    """Array `name` from its ``.zarray`` metadata and chunks."""
    where = f"{store.root}: {name}"
    meta = json.loads(store[f"{name}/.zarray"])
    if meta.get("zarr_format") != 2 or meta.get("filters"):
        raise FormatError(f"{where}: not a zarr v2 array without filters")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise FormatError(f"{where}: unsupported compressor {compressor}")
    try:
        dtype = np.dtype(meta["dtype"])
    except TypeError:
        raise FormatError(f"{where}: unsupported dtype {meta['dtype']}") \
            from None
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape) or meta["order"] not in ("C", "F"):
        raise FormatError(f"{where}: bad chunks {chunks} or order")
    sep = meta.get("dimension_separator", ".")
    out = np.empty(shape, dtype.newbyteorder("="))
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    for index in np.ndindex(*(-(-s // c) for s, c in zip(shape, chunks))):
        key = f"{name}/{sep.join(map(str, index)) or '0'}"
        if key not in store:
            raise FormatError(f"{where}: chunk {key} missing")
        raw = store[key]
        raw = (unzstd(raw, f"{where}: chunk {key}", chunk_bytes)
               if compressor is not None else raw)
        if len(raw) != chunk_bytes:
            raise FormatError(f"{where}: chunk {key} holds {len(raw)} "
                              f"bytes, {chunk_bytes} expected")
        chunk = np.frombuffer(raw, dtype).reshape(chunks, order=meta["order"])
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(index, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    return out


ARRAYS, LEAVES = "arrays.npz", "leaves.json"


def _leaf_paths(tree: Dict[str, Any], prefix: str = ""):
    for name, node in tree.items():
        if isinstance(node, dict) and node:
            yield from _leaf_paths(node, f"{prefix}{name}/")
        else:
            yield prefix + name, node


def save_checkpoint(path: str, tree: Dict[str, Any]) -> None:
    """Write the nested dict `tree` to the directory `path` (made if
    missing, its two files replaced): array leaves (numpy arrays, tensors)
    to ``arrays.npz`` with their dtypes and bits, every other leaf (a
    number, a string, an empty dict) to ``leaves.json``.  `load_checkpoint`
    gives the tree back, leaf for leaf."""
    arrays, leaves = {}, {}
    for key, node in _leaf_paths(tree):
        if isinstance(node, torch.Tensor):
            node = node.detach().cpu().numpy()
        if isinstance(node, (np.ndarray, np.generic)):
            arrays[key] = np.asarray(node)
        else:
            leaves[key] = node
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, ARRAYS), **arrays)
    with open(os.path.join(path, LEAVES), "w") as f:
        json.dump(leaves, f, indent=1, sort_keys=True)


def _load_port_checkpoint(path: str) -> Dict[str, Any]:
    tree = load_npz_tree(os.path.join(path, ARRAYS))
    with open(os.path.join(path, LEAVES)) as f:
        leaves = json.load(f)
    for key, value in leaves.items():
        *parents, leaf = key.split("/")
        node = tree
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = value
    return tree


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The nested dict in the checkpoint directory at `path`: an orbax
    checkpoint of the JAX package, as its ``load_checkpoint(path)`` returns
    it (numpy arrays), or one that `save_checkpoint` wrote.  Any fault in an
    orbax tree raises (`FormatError` for its contents); nothing returns a
    partial tree."""
    path = os.path.abspath(path)
    if os.path.exists(os.path.join(path, ARRAYS)):
        return _load_port_checkpoint(path)
    try:
        with open(os.path.join(path, "_METADATA")) as f:
            meta = json.load(f)
    except FileNotFoundError:
        raise FormatError(f"{path}: neither _METADATA (an orbax checkpoint) "
                          f"nor {ARRAYS} (this package's)") from None
    if meta.get("use_zarr3"):
        raise FormatError(f"{path}: zarr v3 arrays are not supported")
    store = OcdbtReader(path)
    tree: Dict[str, Any] = {}
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        value = entry["value_metadata"]
        if (any(k["key_type"] != _DICT_KEY for k in keys)
                or value["value_type"] not in _VALUE_TYPES
                or value.get("skip_deserialize")):
            raise FormatError(f"{path}: unsupported tree entry {entry}")
        names = [k["key"] for k in keys]
        node = tree
        for name in names[:-1]:
            node = node.setdefault(name, {})
        array = _zarr_array(store, ".".join(names))
        if value["value_type"] == "scalar" and array.dtype.itemsize == 8:
            # a Python number, stored 64-bit; JAX hands it back as a 0-d
            # array of its 32-bit default type
            array = array.astype(f"{array.dtype.kind}4")
        node[names[-1]] = array
    return tree


def leaf_digests(tree: Dict[str, Any], prefix: str = "") -> Dict[str, str]:
    """{"/"-joined path: "dtype shape sha256 of the bytes"} of every leaf."""
    out = {}
    for name, node in tree.items():
        if isinstance(node, dict):
            out.update(leaf_digests(node, f"{prefix}{name}/"))
        else:
            a = np.ascontiguousarray(node)
            out[prefix + name] = (f"{a.dtype.str} {list(a.shape)} "
                                  f"{hashlib.sha256(a.tobytes()).hexdigest()}")
    return out


def latest_step_dir(root: str) -> Optional[str]:
    """Most recent step_N subdirectory under a training run root."""
    if not os.path.isdir(root):
        return None
    steps = [d for d in os.listdir(root) if d.startswith("step_")]
    if not steps:
        return None
    best = max(steps, key=lambda d: int(d.split("_")[1]))
    return os.path.join(root, best)


def load_npz_tree(path: str) -> Dict[str, Any]:
    """Nested dict of numpy arrays from an ``.npz`` whose keys are the tree's
    "/"-joined paths (e.g. ``params/ConvTranspose_0/kernel``)."""
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = tree
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = data[key]
    return tree


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _conv(kernel) -> torch.Tensor:
    return _t(kernel).permute(3, 2, 0, 1).contiguous()


def _convt(kernel) -> torch.Tensor:
    return _t(kernel).flip(0, 1).permute(2, 3, 0, 1).contiguous()


def _batch_norm(sd, prefix, params, stats) -> None:
    sd[prefix + "weight"] = _t(params["scale"])
    sd[prefix + "bias"] = _t(params["bias"])
    sd[prefix + "running_mean"] = _t(stats["mean"])
    sd[prefix + "running_var"] = _t(stats["var"])
    sd[prefix + "num_batches_tracked"] = torch.tensor(0)


# flax's auto-named layers -> the port's ModuleLists (`Conv_3` -> `conv.3`)
_LISTS = {"Conv": "conv", "SNConv": "conv", "ConvTranspose": "convt",
          "BatchNorm": "bn", "Dense": "dense"}


def _map_leaves(tree: Dict[str, Any], fn) -> Dict[str, Any]:
    return {k: _map_leaves(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def state_dict_from_flax(tree: Dict[str, Any],
                         instance: Optional[int] = None
                         ) -> Dict[str, torch.Tensor]:
    """state_dict of the port's modules (and, renamed by
    `generator_state_dict_from_flax`, its generators) from a flax
    {"params": ..., "batch_stats": ..., ["spectral_stats": ...]} tree of the
    same module: named submodules (``encoder``, ``mean_head``,
    ``Encoder_0``, ...) keep their names, flax's ``<Layer>_<i>`` become
    ``<list>.<i>``, ``log_gain`` stays a parameter.  Other top-level entries
    (a VAE's ``latent_dim``, ...) are ignored.  A tree of `jax.vmap`-ed
    instances (the DIP solver's R decoders) carries a leading instance axis
    on every leaf; `instance` r takes leaf [r], instance r's module."""
    if instance is not None:
        tree = {k: _map_leaves(v, lambda a: np.asarray(a)[instance])
                for k, v in tree.items()
                if k in ("params", "batch_stats", "spectral_stats")}
    sd: Dict[str, torch.Tensor] = {}

    def walk(params, stats, spectral, prefix):
        for name, node in params.items():
            kind, _, index = name.rpartition("_")
            target = (f"{prefix}{_LISTS[kind]}.{index}."
                      if kind in _LISTS and index.isdigit()
                      else f"{prefix}{name}.")
            if not isinstance(node, dict):
                sd[target[:-1]] = _t(node)              # e.g. log_gain
            elif kind == "BatchNorm":
                _batch_norm(sd, target, node, stats[name])
            elif "kernel" in node:
                k = node["kernel"]
                sd[target + "weight"] = (
                    _convt(k) if kind == "ConvTranspose"
                    else _conv(k) if k.ndim == 4 else _t(k).T.contiguous())
                if "bias" in node:
                    sd[target + "bias"] = _t(node["bias"])
                if kind == "SNConv":
                    sd[target + "u"] = _t(spectral[name]["u"])
            else:
                walk(node, stats.get(name, {}), spectral.get(name, {}),
                     target)

    walk(tree["params"], tree.get("batch_stats", {}),
         tree.get("spectral_stats", {}), "")
    return sd


# the port's lists -> flax's layer kinds (a `conv.<i>` with a `u` buffer is
# an SNConv)
_KINDS = {"conv": "Conv", "convt": "ConvTranspose", "bn": "BatchNorm",
          "dense": "Dense"}


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float32)


def flax_from_state_dict(sd) -> Dict[str, Any]:
    """The flax {"params": ..., "batch_stats": ..., ["spectral_stats":
    ...]} tree (numpy float32) of a state_dict of the port's modules: the
    inverse of `state_dict_from_flax`.  BatchNorm's ``num_batches_tracked``
    has no flax counterpart and is dropped.  A list of state_dicts (the
    instances of one module) gives their trees stacked on a leading
    instance axis, as `jax.vmap` of the module's init does: the inverse of
    `state_dict_from_flax(tree, instance=r)`."""
    if isinstance(sd, (list, tuple)):
        return _stack([flax_from_state_dict(one) for one in sd])
    layers: Dict[Tuple[str, ...], Dict[str, torch.Tensor]] = {}
    for key, value in sd.items():
        *path, leaf = key.split(".")
        layers.setdefault(tuple(path), {})[leaf] = value
    out: Dict[str, Any] = {"params": {}}

    def put(collection, path, leaf, value):
        node = out.setdefault(collection, {})
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = value

    for path, leaves in layers.items():
        names, kind = [], None
        for name in path:
            if name.isdigit() and names and names[-1] in _KINDS:
                kind = ("SNConv" if names[-1] == "conv" and "u" in leaves
                        else _KINDS[names[-1]])
                names[-1] = f"{kind}_{name}"
            else:
                names.append(name)
                kind = None
        for leaf, value in leaves.items():
            if kind == "BatchNorm":
                if leaf in ("weight", "bias"):
                    put("params", names, "scale" if leaf == "weight"
                        else leaf, _np(value))
                elif leaf != "num_batches_tracked":
                    put("batch_stats", names, leaf[len("running_"):],
                        _np(value))
            elif leaf == "weight":
                w = value.detach().cpu()
                w = (w.permute(2, 3, 0, 1).flip(0, 1)
                     if kind == "ConvTranspose" else w.permute(2, 3, 1, 0)
                     if w.ndim == 4 else w.T)
                put("params", names, "kernel", _np(w))
            elif leaf == "u":
                put("spectral_stats", names, "u", _np(value))
            else:                          # a bias, or a bare parameter
                put("params", names, leaf, _np(value))
    return out


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


# the generator's names where flax's differ: its Dense stem, its one Conv
_GENERATOR_NAMES = (("dense.0.", "stem."), ("conv.0.", "conv."))


def _renamed(sd, pairs):
    out = {}
    for key, value in sd.items():
        for old, new in pairs:
            if key.startswith(old):
                key = new + key[len(old):]
                break
        out[key] = value
    return out


def generator_state_dict_from_flax(
    tree: Dict[str, Any],
) -> Tuple[Dict[str, torch.Tensor], float]:
    """(state_dict of `DCGANGenerator`, output scale) from a flax generator's
    {"params": ..., "batch_stats": ..., ["scale"]} tree."""
    sd = _renamed(state_dict_from_flax(tree), _GENERATOR_NAMES)
    scale = float(np.asarray(tree["scale"])) if "scale" in tree else 1.0
    return sd, scale


def flax_from_generator(gen: DCGANGenerator) -> Dict[str, Any]:
    """The flax {"params": ..., "batch_stats": ...} tree of a generator."""
    return flax_from_state_dict(_renamed(
        gen.state_dict(), [(new, old) for old, new in _GENERATOR_NAMES]))


def load_generator(tree: Dict[str, Any], z_dim: int = 256,
                   device: Optional[str] = None
                   ) -> Tuple[DCGANGenerator, float]:
    """(generator in eval mode with the tree's weights, output scale)."""
    sd, scale = generator_state_dict_from_flax(tree)
    gen = make_generator(z_dim)
    gen.load_state_dict(sd)
    return gen.to(device).eval(), scale
