"""The safetensors file format, read and written by the port itself (no
``safetensors`` package is needed).

A file is an 8-byte little-endian header length, a JSON header of
``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` (plus an
optional ``"__metadata__"`` map of strings), padded with spaces to a
multiple of 8 bytes, then the tensors' raw little-endian bytes, offsets
counted from the end of the header.

:class:`SafeTensorsFile` maps one tensor at a time: :meth:`~SafeTensorsFile.
get` returns a CPU tensor over a private (copy-on-write) map of just that
tensor's bytes, which is unmapped when the tensor is dropped, so reading a
32 GB checkpoint leaf by leaf never holds the whole file in host memory.
:func:`write_file` writes tensor by tensor: the header is laid out from
the names, dtypes and shapes first, then each tensor is produced, written
and dropped in turn.
"""

from __future__ import annotations

import json
import math
import os
import struct
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

DTYPES: Dict[str, torch.dtype] = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool}
NAMES = {dt: name for name, dt in DTYPES.items()}
_ALIGN = 8


class SafeTensorsFile:
    """One safetensors file: its header read at construction, its tensors
    mapped on demand."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            raw = f.read(8)
            if len(raw) != 8:
                raise ValueError(f"{path}: not a safetensors file (no "
                                 "header length)")
            (n,) = struct.unpack("<Q", raw)
            header = json.loads(f.read(n))
        self.metadata = header.pop("__metadata__", None) or {}
        self._data_start = 8 + n
        size = os.path.getsize(path)
        self._entries: Dict[str, Tuple[torch.dtype, Tuple[int, ...], int,
                                       int]] = {}
        for name, e in header.items():
            if e["dtype"] not in DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has dtype "
                                 f"{e['dtype']}, which the reader does not "
                                 f"take ({sorted(DTYPES)})")
            dt = DTYPES[e["dtype"]]
            shape = tuple(int(s) for s in e["shape"])
            begin, end = (int(o) for o in e["data_offsets"])
            want = math.prod(shape) * _itemsize(dt)
            if end - begin != want or self._data_start + end > size:
                raise ValueError(f"{path}: tensor {name!r} spans bytes "
                                 f"[{begin}, {end}), {want} expected within "
                                 f"a file of {size}")
            self._entries[name] = (dt, shape, begin, end)

    def keys(self):
        return list(self._entries)

    def get(self, name: str) -> torch.Tensor:
        """Tensor ``name`` as a CPU tensor over a private map of its bytes
        (writable; writes stay in this process's copy)."""
        dt, shape, begin, end = self._entries[name]
        if end == begin:
            return torch.empty(shape, dtype=dt)
        mm = np.memmap(self.path, dtype=np.uint8, mode="c",
                       offset=self._data_start + begin, shape=(end - begin,))
        return torch.from_numpy(mm).view(dt).reshape(shape)


def _itemsize(dt: torch.dtype) -> int:
    return torch.empty((), dtype=dt).element_size()


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a file, each over its own map (nothing is read
    until a tensor is touched)."""
    f = SafeTensorsFile(path)
    return {k: f.get(k) for k in f.keys()}


def write_file(path: str,
               specs: Sequence[Tuple[str, torch.dtype, Sequence[int]]],
               produce: Callable[[str], torch.Tensor],
               metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write ``specs`` (``(name, dtype, shape)``, in file order) to
    ``path``: the header first, then ``produce(name)`` for each name in
    turn, a CPU tensor of that dtype and shape, written and dropped before
    the next is produced.  Returns the bytes written.  The file appears
    whole or not at all (written beside, then renamed)."""
    header: Dict[str, dict] = {}
    offset = 0
    for name, dt, shape in specs:
        if dt not in NAMES:
            raise ValueError(f"{name!r}: dtype {dt} has no safetensors name")
        if name == "__metadata__" or name in header:
            raise ValueError(f"tensor name {name!r} is reserved or repeated")
        n = math.prod(shape) * _itemsize(dt)
        header[name] = {"dtype": NAMES[dt], "shape": [int(s) for s in shape],
                        "data_offsets": [offset, offset + n]}
        offset += n
    if metadata:
        header = {"__metadata__": {str(k): str(v)
                                   for k, v in metadata.items()}, **header}
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % _ALIGN)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(struct.pack("<Q", len(blob)))
            f.write(blob)
            for name, dt, shape in specs:
                t = produce(name)
                if t.dtype != dt or tuple(t.shape) != tuple(shape) \
                        or t.device.type != "cpu":
                    raise ValueError(
                        f"{name!r}: produced {t.dtype} {tuple(t.shape)} on "
                        f"{t.device}, the header says {dt} {tuple(shape)} "
                        "on the CPU")
                raw = t.contiguous().reshape(-1).view(torch.uint8).numpy()
                f.write(memoryview(raw))
                del t, raw
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return 8 + len(blob) + offset


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write a dict of CPU tensors (the ``safetensors.torch.save_file``
    call)."""
    specs = [(k, t.dtype, tuple(t.shape)) for k, t in tensors.items()]
    return write_file(path, specs, tensors.__getitem__, metadata)
