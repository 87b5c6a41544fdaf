"""Versioned binary container for keys and ciphertexts: the JAX package's
format (``nufhe_tpu/serialization.py``), byte for byte, so that a container
written by either package loads in the other.

It replaces the reference's pickle-based dump/load
(``nufhe/api_low_level.py``, ``nufhe/lwe.py:207-243``) with an explicit
format: a JSON manifest followed by raw little-endian array payloads.  No
pickle: loading untrusted key or ciphertext files cannot execute code.

Format:
    magic   b"NFTPU" + 3-byte version
    u64     manifest length
    bytes   JSON manifest: {"meta": {...}, "arrays": [{name, dtype, shape}]}
    bytes   concatenated C-order array payloads
"""

import io
import json

import numpy as np

MAGIC = b"NFTPU001"


def dump(file_obj, meta: dict, arrays: dict):
    """Write ``meta`` (JSON-serializable) and named numpy arrays."""
    manifest = {
        "meta": meta,
        "arrays": [
            {"name": name,
             "dtype": np.asarray(arr).dtype.str,
             "shape": list(np.asarray(arr).shape)}
            for name, arr in arrays.items()
        ],
    }
    blob = json.dumps(manifest).encode("utf-8")
    file_obj.write(MAGIC)
    file_obj.write(len(blob).to_bytes(8, "little"))
    file_obj.write(blob)
    for arr in arrays.values():
        file_obj.write(np.ascontiguousarray(np.asarray(arr)).tobytes())


def load(file_obj):
    """Read (meta, arrays) written by :func:`dump`."""
    magic = file_obj.read(len(MAGIC))
    if magic != MAGIC:
        raise ValueError("Not a nufhe_tpu container (bad magic)")
    blob_len = int.from_bytes(file_obj.read(8), "little")
    manifest = json.loads(file_obj.read(blob_len).decode("utf-8"))
    arrays = {}
    for spec in manifest["arrays"]:
        dtype = np.dtype(spec["dtype"])
        shape = tuple(spec["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        data = file_obj.read(count * dtype.itemsize)
        arrays[spec["name"]] = np.frombuffer(data, dtype).reshape(shape).copy()
    return manifest["meta"], arrays


def dumps(meta, arrays):
    buf = io.BytesIO()
    dump(buf, meta, arrays)
    return buf.getvalue()


def loads(data: bytes):
    return load(io.BytesIO(data))
