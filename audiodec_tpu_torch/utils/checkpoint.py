"""Checkpoints in the JAX package's format (counterpart of
audiodec_tpu/train/checkpoint.py: `save_checkpoint`, `load_checkpoint`,
`load_only_params`), read and written with the standard library and numpy.

A file is an 8-byte little-endian header length, a JSON header (`steps`
and any extras), then flax's `serialization.to_bytes` payload: msgpack of
the state dict, where flax has turned every list into a map with keys
"0".."n-1" and every numpy array into msgpack ext type 1, a msgpack
(shape, dtype name, C-order bytes); a numpy scalar is ext type 3, the same
encoding of a 0-d array.  The machine with the card has no msgpack, so
`_pack` and `_Unpacker` implement the part of it that flax writes.  The
reader raises on flax's chunked form of arrays over 1 GiB and on any ext
type other than 1 and 3.

Trees hold numpy arrays in the JAX package's layout; utils/bridge.py turns
them into the port's tensors and back.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Optional

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


# ---------------------------------------------------------------------------
# msgpack, the part flax writes
# ---------------------------------------------------------------------------

def _pack_len(out: bytearray, n: int, fix: int, fix_max: int, codes):
    """Length header: a fix form below fix_max, else 8/16/32-bit forms
    (codes: a byte per width, None where the type has no 8-bit form)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n < 1 << 8:
        out += bytes([codes[0], n])
    elif n < 1 << 16:
        out.append(codes[1])
        out += struct.pack(">H", n)
    elif n < 1 << 32:
        out.append(codes[2])
        out += struct.pack(">I", n)
    else:
        raise ValueError(f"msgpack object of {n} items or bytes")


def _pack_int(out: bytearray, v: int):
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, bits in ((0xCC, ">B", 8), (0xCD, ">H", 16),
                                (0xCE, ">I", 32), (0xCF, ">Q", 64)):
            if v < 1 << bits:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"int {v} too large for msgpack")
    else:
        for code, fmt, bits in ((0xD0, ">b", 8), (0xD1, ">h", 16),
                                (0xD2, ">i", 32), (0xD3, ">q", 64)):
            if v >= -(1 << (bits - 1)):
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"int {v} too small for msgpack")


def _pack_ext(out: bytearray, code: int, data: bytes):
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_len(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _ndarray_bytes(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.fields is not None:
        raise ValueError(f"cannot serialize dtype {a.dtype}")
    out = bytearray()
    _pack(out, [list(a.shape), a.dtype.name, a.tobytes("C")])
    return bytes(out)


def _pack(out: bytearray, v):
    if v is None:
        out.append(0xC0)
    elif isinstance(v, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_bytes(v))
    elif isinstance(v, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_bytes(np.asarray(v)))
    elif isinstance(v, bool):
        out.append(0xC3 if v else 0xC2)
    elif isinstance(v, int):
        _pack_int(out, v)
    elif isinstance(v, float):
        out.append(0xCB)
        out += struct.pack(">d", v)
    elif isinstance(v, str):
        data = v.encode()
        _pack_len(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(v, (bytes, bytearray)):
        _pack_len(out, len(v), None, 0, (0xC4, 0xC5, 0xC6))
        out += v
    elif isinstance(v, (list, tuple)):
        _pack_len(out, len(v), 0x90, 16, (None, 0xDC, 0xDD))
        for item in v:
            _pack(out, item)
    elif isinstance(v, dict):
        _pack_len(out, len(v), 0x80, 16, (None, 0xDE, 0xDF))
        for k, item in v.items():
            _pack(out, k)
            _pack(out, item)
    else:
        raise TypeError(f"cannot serialize {type(v).__name__}")


class _Unpacker:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        c = self.unpack(">B")
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if c & 0xF0 == 0x80:
            return self.map(c & 0x0F)
        if c & 0xF0 == 0x90:
            return [self.value() for _ in range(c & 0x0F)]
        if c & 0xE0 == 0xA0:
            return str(self.take(c & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
                0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if c in ints:
            return self.unpack(ints[c])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B",
                   0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I",
                   0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
                   0xC9: ">I"}
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if c in fixext:
            return self.ext(fixext[c])
        if c not in lengths:
            raise ValueError(f"unknown msgpack type byte 0x{c:02x}")
        n = self.unpack(lengths[c])
        if c <= 0xC6:
            return bytes(self.take(n))
        if c <= 0xC9:
            return self.ext(n)
        if c <= 0xDB:
            return str(self.take(n), "utf-8")
        if c <= 0xDD:
            return [self.value() for _ in range(n)]
        return self.map(n)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if _CHUNKED in out:
            raise ValueError("flax's chunked array form (arrays over 1 GiB) "
                             "is not supported")
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unknown msgpack ext type {code}")
        inner = _Unpacker(data)
        shape, name, buf = inner.value()
        arr = np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def msgpack_restore(payload: bytes):
    """flax `serialization.msgpack_restore` on flax's own output."""
    unpacker = _Unpacker(payload)
    state = unpacker.value()
    if unpacker.pos != len(payload):
        raise ValueError("trailing bytes after the msgpack payload")
    return state


def to_state_dict(tree):
    """flax's `to_state_dict` for trees of dicts, lists and leaves: a list
    or tuple becomes a map with keys "0".."n-1"."""
    if isinstance(tree, dict):
        return {k: to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def to_bytes(tree) -> bytes:
    """flax `serialization.to_bytes` of a tree of dicts, lists and numpy
    arrays or scalars."""
    out = bytearray()
    _pack(out, to_state_dict(tree))
    return bytes(out)


# ---------------------------------------------------------------------------
# the checkpoint files
# ---------------------------------------------------------------------------

def _as_arrays(tree):
    if isinstance(tree, dict):
        return {k: _as_arrays(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_as_arrays(v) for v in tree]
    return tree if tree is None else np.asarray(tree)


def save_checkpoint(path: str, state: Dict[str, Any], steps: int,
                    extra: Optional[dict] = None) -> None:
    """Write `state` (dicts, lists, array-like leaves) in the JAX format;
    every leaf is stored as a numpy array, as the JAX package does."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = to_bytes(_as_arrays(state))
    header = json.dumps({"steps": int(steps), **(extra or {})}).encode()
    with open(path, "wb") as f:
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        f.write(payload)


def load_checkpoint(path: str):
    """-> (state, header), the state as flax restores it without a template:
    nested dicts, lists still as maps keyed "0".."n-1"."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n).decode())
        payload = f.read()
    return msgpack_restore(payload), header


def restore_lists(tree):
    """Maps keyed exactly "0".."n-1" back to lists, as flax's
    `from_state_dict` does where the template holds a list."""
    if isinstance(tree, dict):
        if tree and sorted(tree) == sorted(str(i) for i in range(len(tree))):
            return [restore_lists(tree[str(i)]) for i in range(len(tree))]
        return {k: restore_lists(v) for k, v in tree.items()}
    return tree


def fold_norms(tree):
    """Norm-reparametrized convs folded into {w[, b]}, in f32, as the JAX
    package folds them on load (audiodec_tpu/ops/norms.py:56-87):
    weight norm {v, g[, b]}, w = g * v / ||v|| over the axes where g has
    size 1; spectral norm {w_raw, u[, b]}, w = w_raw / sigma after one
    power iteration from u over the (everything else, O) matricization."""
    if isinstance(tree, dict) and "v" in tree and "g" in tree:
        v = np.asarray(tree["v"], np.float32)
        g = np.asarray(tree["g"], np.float32)
        axes = tuple(i for i, s in enumerate(g.shape) if s == 1)
        out = {"w": g * v / np.sqrt(np.sum(v * v, axis=axes, keepdims=True))}
    elif isinstance(tree, dict) and "w_raw" in tree and "u" in tree:
        w = np.asarray(tree["w_raw"], np.float32)
        mat = w.reshape(-1, w.shape[-1])
        v = mat @ np.asarray(tree["u"], np.float32)
        v = v / (np.linalg.norm(v) + 1e-12)
        u = mat.T @ v
        u = u / (np.linalg.norm(u) + 1e-12)
        out = {"w": w / (v @ (mat @ u))}
    elif isinstance(tree, dict):
        return {k: fold_norms(v) for k, v in tree.items()}
    elif isinstance(tree, list):
        return [fold_norms(v) for v in tree]
    else:
        return tree
    if "b" in tree:
        out["b"] = tree["b"]
    return out


def load_only_params(path: str, key: str = "gen", fold: bool = True):
    """-> (params, header): the `key` sub-tree (or the whole state if it has
    no such key) with its lists restored and, with fold, the norm
    reparametrizations folded; numpy arrays in the JAX package's layout."""
    state, header = load_checkpoint(path)
    sub = restore_lists(state[key] if key in state else state)
    return (fold_norms(sub) if fold else sub), header
