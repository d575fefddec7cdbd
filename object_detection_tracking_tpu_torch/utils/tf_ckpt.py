"""TF-free TensorFlow checkpoint (tensor bundle, V2) reader.

The reference restores TF ckpt dirs / single .ckpt prefixes
(models.py:3489-3595). TensorFlow is absent in this image, but the V2
checkpoint format is just a readable tensor bundle:

  <prefix>.index            — a LevelDB-format immutable table mapping
                              tensor names to BundleEntryProto records
                              (dtype, shape, shard, offset, size);
  <prefix>.data-NNNNN-of-MMMMM — concatenated little-endian raw tensor
                              bytes.

This module parses both with no TF dependency: a minimal LevelDB table
reader (block format + footer magic per leveldb/table_format.md), a pure-
python snappy decoder (blocks are usually uncompressed, but the format
allows snappy), and a minimal protobuf varint decoder for
BundleHeaderProto / BundleEntryProto (tensorflow/core/protobuf/
tensor_bundle.proto).

CRC32C checksums are not verified (no stdlib crc32c); shape/size
consistency is checked instead.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np

# leveldb table footer magic (table_format.md)
_TABLE_MAGIC = 0xdb4775248b80fb57

# TF DataType enum -> numpy dtype (types.proto)
_DTYPES = {
    1: np.dtype("<f4"),    # DT_FLOAT
    2: np.dtype("<f8"),    # DT_DOUBLE
    3: np.dtype("<i4"),    # DT_INT32
    4: np.dtype("<u1"),    # DT_UINT8
    5: np.dtype("<i2"),    # DT_INT16
    6: np.dtype("<i1"),    # DT_INT8
    9: np.dtype("<i8"),    # DT_INT64
    10: np.dtype("?"),     # DT_BOOL
    14: np.dtype("<u2"),   # DT_BFLOAT16 (raw bits; converted below)
    17: np.dtype("<u2"),   # DT_UINT16
    19: np.dtype("<f2"),   # DT_HALF
    22: np.dtype("<u4"),   # DT_UINT32
    23: np.dtype("<u8"),   # DT_UINT64
}
_DT_BFLOAT16 = 14
_DT_STRING = 7


# ---------------------------------------------------------------------------
# varint / protobuf primitives


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _proto_fields(buf: bytes):
    """Yield (field_number, wire_type, value) for a protobuf message.
    value is int for varint/fixed, bytes for length-delimited."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:          # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:        # fixed64
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:        # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:        # fixed32
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_shape(buf: bytes) -> List[int]:
    """TensorShapeProto: repeated Dim dim = 2 {int64 size = 1}."""
    dims = []
    for field, _, val in _proto_fields(buf):
        if field == 2:
            size = 0
            for f2, _, v2 in _proto_fields(val):
                if f2 == 1:
                    size = v2
            dims.append(size)
    return dims


def _parse_bundle_entry(buf: bytes) -> Dict:
    """BundleEntryProto: dtype=1, shape=2, shard_id=3, offset=4, size=5,
    crc32c=6, slices=7 (partitioned variables unsupported)."""
    e = {"dtype": 0, "shape": [], "shard_id": 0, "offset": 0, "size": 0}
    for field, _, val in _proto_fields(buf):
        if field == 1:
            e["dtype"] = val
        elif field == 2:
            e["shape"] = _parse_shape(val)
        elif field == 3:
            e["shard_id"] = val
        elif field == 4:
            e["offset"] = val
        elif field == 5:
            e["size"] = val
        elif field == 7:
            raise ValueError("partitioned (sliced) variables unsupported")
    return e


# ---------------------------------------------------------------------------
# snappy block decompression (format: format_description.txt)


def snappy_decompress(data: bytes) -> bytes:
    out_len, pos = _read_varint(data, 0)
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:                       # literal
            ln = tag >> 2
            if ln >= 60:
                nbytes = ln - 59
                ln = int.from_bytes(data[pos:pos + nbytes], "little")
                pos += nbytes
            ln += 1
            out += data[pos:pos + ln]
            pos += ln
        else:                               # copy
            if kind == 1:
                ln = ((tag >> 2) & 0x7) + 4
                offset = ((tag >> 5) << 8) | data[pos]
                pos += 1
            elif kind == 2:
                ln = (tag >> 2) + 1
                offset = struct.unpack_from("<H", data, pos)[0]
                pos += 2
            else:
                ln = (tag >> 2) + 1
                offset = struct.unpack_from("<I", data, pos)[0]
                pos += 4
            start = len(out) - offset
            for i in range(ln):             # may overlap itself
                out.append(out[start + i])
    if len(out) != out_len:
        raise ValueError("snappy: length mismatch")
    return bytes(out)


# ---------------------------------------------------------------------------
# leveldb immutable table reader


def _read_block(data: bytes, offset: int, size: int) -> bytes:
    """BlockHandle contents + 1-byte type + 4-byte crc."""
    raw = data[offset:offset + size]
    ctype = data[offset + size]
    if ctype == 0:
        return raw
    if ctype == 1:
        return snappy_decompress(raw)
    raise ValueError(f"unsupported block compression {ctype}")


def _block_entries(block: bytes):
    """Yield (key, value) from a leveldb block (prefix-compressed keys)."""
    if len(block) < 4:
        return
    num_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    data_end = len(block) - 4 - 4 * num_restarts
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = _read_varint(block, pos)
        unshared, pos = _read_varint(block, pos)
        value_len, pos = _read_varint(block, pos)
        key = key[:shared] + block[pos:pos + unshared]
        pos += unshared
        value = block[pos:pos + value_len]
        pos += value_len
        yield key, value


def _table_items(path: str) -> List[Tuple[bytes, bytes]]:
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 48:
        raise ValueError(f"{path}: too short for a leveldb table")
    footer = data[-48:]
    magic = struct.unpack_from("<Q", footer, 40)[0]
    if magic != _TABLE_MAGIC:
        raise ValueError(f"{path}: bad table magic {magic:#x}")
    pos = 0
    _, pos = _read_varint(footer, pos)      # metaindex offset
    _, pos = _read_varint(footer, pos)      # metaindex size
    idx_off, pos = _read_varint(footer, pos)
    idx_size, pos = _read_varint(footer, pos)
    index = _read_block(data, idx_off, idx_size)
    items = []
    for _, handle in _block_entries(index):
        off, hpos = _read_varint(handle, 0)
        size, _ = _read_varint(handle, hpos)
        for k, v in _block_entries(_read_block(data, off, size)):
            items.append((k, v))
    return items


# ---------------------------------------------------------------------------
# public API


def _resolve_prefix(path: str) -> str:
    """Accept a ckpt prefix, a .index path, or a ckpt directory (uses the
    latest prefix named in its 'checkpoint' state file, like
    tf.train.latest_checkpoint)."""
    if os.path.isdir(path):
        state = os.path.join(path, "checkpoint")
        if os.path.exists(state):
            with open(state) as f:
                for line in f:
                    if line.startswith("model_checkpoint_path:"):
                        name = line.split(":", 1)[1].strip().strip('"')
                        if not os.path.isabs(name):
                            name = os.path.join(path, name)
                        return name
        cands = sorted(p for p in os.listdir(path) if p.endswith(".index"))
        if not cands:
            raise FileNotFoundError(f"no .index files under {path}")
        return os.path.join(path, cands[-1][:-len(".index")])
    if path.endswith(".index"):
        return path[:-len(".index")]
    return path


def list_tf_checkpoint(path: str) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """Tensor name -> (shape, tf_dtype_enum) for a V2 checkpoint."""
    prefix = _resolve_prefix(path)
    out = {}
    for key, value in _table_items(prefix + ".index"):
        if not key:
            continue  # header entry
        e = _parse_bundle_entry(value)
        out[key.decode()] = (tuple(e["shape"]), e["dtype"])
    return out


def load_tf_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Read every (non-string) tensor of a TF V2 checkpoint into numpy."""
    prefix = _resolve_prefix(path)
    header = None
    entries = {}
    for key, value in _table_items(prefix + ".index"):
        if not key:
            # BundleHeaderProto: num_shards = 1
            header = {f: v for f, _, v in _proto_fields(value)}
            continue
        entries[key.decode()] = _parse_bundle_entry(value)

    num_shards = int(header.get(1, 1)) if header else 1
    shards = {}
    for sid in range(num_shards):
        fname = f"{prefix}.data-{sid:05d}-of-{num_shards:05d}"
        with open(fname, "rb") as f:
            shards[sid] = f.read()

    tensors = {}
    for name, e in entries.items():
        if e["dtype"] == _DT_STRING:
            continue
        dt = _DTYPES.get(e["dtype"])
        if dt is None:
            continue
        raw = shards[e["shard_id"]][e["offset"]:e["offset"] + e["size"]]
        arr = np.frombuffer(raw, dtype=dt)
        if e["dtype"] == _DT_BFLOAT16:
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        n = int(np.prod(e["shape"])) if e["shape"] else 1
        if arr.size != n:
            raise ValueError(
                f"{name}: payload has {arr.size} elements, shape "
                f"{e['shape']} wants {n}")
        tensors[name] = arr.reshape(e["shape"])
    return tensors
