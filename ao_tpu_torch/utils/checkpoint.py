"""Checkpoints (port of ao_tpu/utils/checkpoint.py).

The port's own checkpoints are a dict of model, optimizer and scheduler
``state_dict``s plus counters, written to ``<path>.tmp`` and atomically
renamed. The JAX package's ``.ckpt`` files are flax msgpack; the port
reads them with :func:`msgpack_restore`, a pure-Python reader of the
subset flax writes (so neither flax nor msgpack is needed): maps, arrays,
strings, binaries, integers, floats, booleans and nil, with flax's
extension types 1 (an ndarray: a msgpack of shape, dtype name and raw C
bytes) and 3 (a numpy scalar, encoded as an ndarray), and flax's chunked
arrays (``__msgpack_chunked_array__``).
"""

from __future__ import annotations

import os
import shutil
import struct
from typing import Any, Dict

import numpy as np
import torch


def save_checkpoint(path: str, state: Dict[str, Any]):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    return torch.load(path, map_location=map_location, weights_only=True)


def copy_best(path: str, best_path: str):
    """Copy the checkpoint at ``path`` to ``best_path``."""
    shutil.copyfile(path, best_path)


def filter_state_dict(state_dict: Dict, keywords: Dict[str, str]) -> Dict:
    """Keyword-renamed partial load for fine-tuning (reference:
    hooks/misc.py:213-239): a key holding a substring of ``keywords`` has
    its first such substring replaced by its replacement; other keys stay
    as they are. An empty substring matches nothing."""
    out = {}
    for k, v in state_dict.items():
        new_k = k
        for kw, rep in keywords.items():
            if kw and kw in k:
                new_k = k.replace(kw, rep)
                break
        out[new_k] = v
    return out


# ---------------------------------------------------------------------------
# flax msgpack
# ---------------------------------------------------------------------------

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype, buf = _Reader(data, raw=True).read()
    if dtype == b"bfloat16":  # the high 16 bits of float32
        u16 = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return u16.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(dtype.decode())).reshape(shape).copy()


class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.data = data
        self.pos = 0
        self.raw = raw  # strings as bytes (flax's inner ndarray encoding)

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def ext(self, code: int, n: int):
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            return _ndarray(data)[()]
        raise ValueError(f"msgpack: extension type {code} is not flax's")

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        scalars = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
                   0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in scalars:
            return self.unpack(scalars[b])
        # (kind, format of the length) of the types with a length field
        sized = {0xC4: ("bin", "B"), 0xC5: ("bin", "H"), 0xC6: ("bin", "I"),
                 0xC7: ("ext", "B"), 0xC8: ("ext", "H"), 0xC9: ("ext", "I"),
                 0xD9: ("str", "B"), 0xDA: ("str", "H"), 0xDB: ("str", "I"),
                 0xDC: ("array", "H"), 0xDD: ("array", "I"),
                 0xDE: ("map", "H"), 0xDF: ("map", "I")}
        if b in sized:
            kind, fmt = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.string(n)
            if kind == "array":
                return [self.read() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            return self.ext(self.unpack("b"), n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(self.unpack("b"), fixext[b])
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _unchunk(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes):
    """The tree of a flax ``msgpack_serialize`` payload: dicts, lists,
    Python scalars and numpy arrays (flax.serialization.msgpack_restore's
    result for the subset flax writes)."""
    r = _Reader(data)
    tree = r.read()
    if r.pos != len(data):
        raise ValueError("msgpack: trailing bytes after the payload")
    return _unchunk(tree)


def load_flax_checkpoint(path: str):
    """(state tree, meta) of a JAX package checkpoint (``save_checkpoint``
    of ao_tpu/utils/checkpoint.py: ``{"meta": ..., "state": ...}``)."""
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    return payload.get("state", payload), payload.get("meta", {})
