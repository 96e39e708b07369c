"""Reader for flax ``msgpack_serialize`` checkpoints, in pure Python.

Decodes the subset of msgpack that flax writes — maps, arrays, str, bin, ints,
floats, nil and bool — plus flax's extension types: code 1 (an ndarray, whose
payload is itself a msgpack ``(shape, dtype name, raw bytes)`` triple) and
code 3 (a numpy scalar, the same payload). Returns nested dicts of numpy
arrays, as ``flax.serialization.msgpack_restore`` does. Neither ``msgpack``
nor ``flax`` is needed. :func:`tree_to_state_dict` turns such a tree into a
torch state dict, and :func:`convert_state_dict` turns a torch HiFi-GAN
generator state dict (the published ``.pt`` checkpoints) into such a tree.
"""

import re
import struct
from collections import OrderedDict
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError('truncated msgpack data at byte %d' % self.pos)
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack('>' + fmt, self.take(struct.calcsize('>' + fmt)))[0]

    def read(self) -> Any:
        b = self.unpack('B')
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self._map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self._array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), 'utf-8')
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xc4: ('B', self._bin), 0xc5: ('H', self._bin), 0xc6: ('I', self._bin),
            0xd9: ('B', self._str), 0xda: ('H', self._str), 0xdb: ('I', self._str),
            0xdc: ('H', self._array), 0xdd: ('I', self._array),
            0xde: ('H', self._map), 0xdf: ('I', self._map),
            0xc7: ('B', self._ext), 0xc8: ('H', self._ext), 0xc9: ('I', self._ext),
        }
        if b in sized:
            fmt, fn = sized[b]
            return fn(self.unpack(fmt))
        scalars = {0xca: 'f', 0xcb: 'd', 0xcc: 'B', 0xcd: 'H', 0xce: 'I',
                   0xcf: 'Q', 0xd0: 'b', 0xd1: 'h', 0xd2: 'i', 0xd3: 'q'}
        if b in scalars:
            return self.unpack(scalars[b])
        if 0xd4 <= b <= 0xd8:                      # fixext 1/2/4/8/16
            return self._ext(1 << (b - 0xd4))
        raise ValueError('unsupported msgpack type byte 0x%02x' % b)

    def _bin(self, n: int) -> bytes:
        return bytes(self.take(n))

    def _str(self, n: int) -> str:
        return str(self.take(n), 'utf-8')

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _ext(self, n: int):
        code = self.unpack('b')
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        raise ValueError('unsupported msgpack extension type %d' % code)


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype, buffer = _unpack_triple(payload)
    if isinstance(dtype, bytes):
        dtype = dtype.decode('ascii')
    return np.frombuffer(buffer, dtype=np.dtype(dtype)).reshape(shape)


def _unpack_triple(payload: bytes) -> Tuple[list, Any, bytes]:
    reader = _Reader(payload)
    triple = reader.read()
    if not (isinstance(triple, list) and len(triple) == 3):
        raise ValueError('malformed flax ndarray payload')
    return triple


def msgpack_restore(data: bytes) -> Any:
    """Decode flax-serialized bytes into nested dicts of numpy arrays."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError('trailing bytes after msgpack object')
    return out


def load_msgpack(path: str) -> Any:
    with open(path, 'rb') as f:
        return msgpack_restore(f.read())


def tree_to_state_dict(tree: Dict[str, Any]) -> 'OrderedDict[str, torch.Tensor]':
    """Nested dicts of numpy arrays -> a flat float32 state dict whose keys
    are the tree's paths joined with '.' (``conv_pre.v``,
    ``period_2.conv_0.bias``): the JAX parameter tree's names are the port's
    module paths."""
    state = OrderedDict()

    def walk(node, prefix):
        for key, val in node.items():
            name = prefix + str(key)
            if isinstance(val, dict):
                walk(val, name + '.')
            else:
                state[name] = torch.tensor(np.asarray(val, dtype=np.float32))

    walk(tree, '')
    return state


def convert_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """torch HiFi-GAN generator state dict -> ``{'params': tree}`` of float32
    numpy arrays under the JAX package's paths (the port's copy of the
    mapping of ``pytorch_sound_tpu/scripts/convert_hifigan.py``):
    ``ups.0.*`` -> ``ups_0``; ``resblocks.2.convs1.1.*`` ->
    ``resblocks_2/convs1_1``; ``weight_g`` / ``weight_v`` -> the tree's
    ``g`` / ``v``, which ``load_jax_params`` folds with the JAX formula
    (``g * v / sqrt(sum(v²) + 1e-12)``) as the JAX converter does.
    """
    leaves_named = {'weight_g': 'g', 'weight_v': 'v'}
    params: Dict[str, Any] = {}
    for key, val in state_dict.items():
        parts = key.split('.')
        names = []
        i = 0
        while i < len(parts) - 1:
            if i + 1 < len(parts) - 1 and re.fullmatch(r'\d+', parts[i + 1]):
                names.append('%s_%s' % (parts[i], parts[i + 1]))
                i += 2
            else:
                names.append(parts[i])
                i += 1
        node = params
        for name in names:
            node = node.setdefault(name, {})
        arr = val.detach().cpu().numpy() if isinstance(val, torch.Tensor) else np.asarray(val)
        node[leaves_named.get(parts[-1], parts[-1])] = arr.astype(np.float32)
    return {'params': params}
