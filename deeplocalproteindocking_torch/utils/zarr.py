"""zarr v2 arrays read from a key-value store (an :class:`OcdbtStore`).

Orbax keeps each array of a checkpoint as ``<name>/.zarray`` (JSON) and
its chunks as ``<name>/<i>.<j>...`` (``<name>/0`` for a scalar)::

    arr = read_array(store, "params.coupling")

Each chunk is stored whole (edge chunks too, at the full chunk shape) in
the array's ``order`` (C or F), compressed by the array's compressor
(zstd, or none); a chunk missing from the store is ``fill_value`` (0
where that is null).  Dtypes ``<f4``, ``<u4`` and ``<i4`` are read;
any other dtype, compressor or filter raises :class:`ZarrError`.
"""
from __future__ import annotations

import itertools
import json
import math

import numpy as np

from deeplocalproteindocking_torch.utils.zstd import ZstdError, decompress

__all__ = ["ZarrError", "read_array"]

_DTYPES = {"<f4": np.float32, "<u4": np.uint32, "<i4": np.int32}
_FILL = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}


class ZarrError(ValueError):
    """A zarr array this reader cannot read, or whose chunks are
    damaged."""


def _meta(store, name: str) -> dict:
    try:
        meta = json.loads(store.read(f"{name}/.zarray"))
    except KeyError:
        raise KeyError(f"no zarr array {name!r}") from None
    if meta.get("zarr_format") != 2:
        raise ZarrError(f"{name}: zarr format {meta.get('zarr_format')}")
    if meta.get("dtype") not in _DTYPES:
        raise ZarrError(f"{name}: dtype {meta.get('dtype')!r}")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ZarrError(f"{name}: compressor {comp.get('id')!r}")
    if meta.get("filters"):
        raise ZarrError(f"{name}: filters {meta['filters']!r}")
    if meta.get("order", "C") not in ("C", "F"):
        raise ZarrError(f"{name}: order {meta.get('order')!r}")
    if len(meta["chunks"]) != len(meta["shape"]):
        raise ZarrError(f"{name}: chunks {meta['chunks']} for shape "
                        f"{meta['shape']}")
    return meta


def read_array(store, name: str) -> np.ndarray:
    """The zarr v2 array ``name`` of ``store`` (anything with
    ``read(key) -> bytes`` raising ``KeyError`` for a missing key)."""
    meta = _meta(store, name)
    dtype = np.dtype(_DTYPES[meta["dtype"]])
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    fill = 0 if fill is None else _FILL.get(fill, fill)
    out = np.full(shape, fill, dtype)
    per_chunk = math.prod(chunks) * dtype.itemsize
    grid = [range(math.ceil(s / c)) if c else range(0)
            for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        try:
            raw = store.read(key)
        except KeyError:
            continue
        if meta.get("compressor") is not None:
            try:
                raw = decompress(raw)
            except ZstdError as e:
                raise ZarrError(f"{key}: {e}") from e
        if len(raw) != per_chunk:
            raise ZarrError(f"{key}: {len(raw)} bytes, a chunk of "
                            f"{chunks} {meta['dtype']} is {per_chunk}")
        block = np.frombuffer(raw, dtype).reshape(chunks,
                                                  order=meta.get("order",
                                                                 "C"))
        dst = tuple(slice(i * c, min((i + 1) * c, s))
                    for i, c, s in zip(idx, chunks, shape))
        out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
    return out
