"""The safetensors file format in plain Python and torch (no `safetensors`
package, which the card's installation lacks).

A file is an 8-byte little-endian header length, a JSON header, then the
tensors' bytes back to back. The header maps each name to
`{"dtype", "shape", "data_offsets": [begin, end]}` (offsets into the data
buffer) and may hold a `"__metadata__"` object of strings.

`save_file` writes the bytes `safetensors.numpy.save_file` writes
(safetensors 0.8.0; tests/test_torch_checkpoint.py holds them equal):

* the tensors are laid out by dtype, widest-ranked first (the rank is the
  package's dtype order, `_DTYPES` below, descending), then by name as
  bytes; the header lists them in that order, after `__metadata__` (its
  keys sorted here; safetensors writes two or more metadata keys in a
  hash map's order, which varies from run to run);
* the JSON is compact (no spaces) and the header is padded with spaces to
  a multiple of 8 bytes.

`read_tensors` streams a file one tensor at a time: each tensor's bytes are
read into a buffer of their own and cast to the dtype asked for (and moved
to the device asked for) before the next is read, so an 8 B-parameter
bf16 checkpoint never exists in float32 on the host. bfloat16 goes through
`torch.bfloat16` (its bytes as they are), never through numpy.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Iterator, Mapping

import torch

# safetensors' dtype names, in the package's dtype order (the layout sorts
# by this rank, descending)
_DTYPES = (
    ("BOOL", torch.bool), ("U8", torch.uint8), ("I8", torch.int8),
    ("I16", torch.int16), ("F16", torch.float16), ("BF16", torch.bfloat16),
    ("I32", torch.int32), ("F32", torch.float32), ("F64", torch.float64),
    ("I64", torch.int64),
)
_RANK = {name: i for i, (name, _) in enumerate(_DTYPES)}
_NAME_OF = {dt: name for name, dt in _DTYPES}
_DTYPE_OF = dict(_DTYPES)


def _layout(tensors: Mapping[str, torch.Tensor]) -> list[str]:
    return sorted(tensors, key=lambda k: (-_RANK[_NAME_OF[tensors[k].dtype]],
                                          k.encode()))


def header_bytes(tensors: Mapping[str, torch.Tensor],
                 metadata: Mapping[str, str] | None = None) -> bytes:
    """The length prefix and padded JSON header of a file holding
    `tensors` (in the layout `save_file` writes)."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {k: metadata[k] for k in sorted(metadata)}
    offset = 0
    for name in _layout(tensors):
        t = tensors[name]
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAME_OF[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    text = json.dumps(header, separators=(",", ":"),
                      ensure_ascii=False).encode()
    text += b" " * (-len(text) % 8)
    return struct.pack("<Q", len(text)) + text


def _raw(t: torch.Tensor) -> memoryview:
    """A tensor's bytes, row-major, from the host."""
    t = t.detach().contiguous().cpu()
    if t.dim() == 0:
        t = t.reshape(1)
    return memoryview(t.view(torch.uint8).numpy()) if t.numel() else \
        memoryview(b"")


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Mapping[str, str] | None = None) -> int:
    """Write `tensors` (on any device; one at a time through the host) to
    `path`; returns the bytes written."""
    unknown = {k: t.dtype for k, t in tensors.items()
               if t.dtype not in _NAME_OF}
    if unknown:
        raise TypeError(f"dtypes with no safetensors name: {unknown}")
    head = header_bytes(tensors, metadata)
    total = len(head)
    with open(path, "wb") as f:
        f.write(head)
        for name in _layout(tensors):
            data = _raw(tensors[name])
            f.write(data)
            total += len(data)
    return total


def read_header(path: str) -> tuple[dict, int]:
    """`(header dict, byte offset of the data buffer)` of a file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return header, 8 + n


def read_tensors(path: str, dtype: torch.dtype | None = None,
                 device=None) -> Iterator[tuple[str, torch.Tensor]]:
    """`(name, tensor)` of every tensor in `path`, in the header's order,
    read one at a time and cast to `dtype` (kept as stored when None) on
    `device` (the host when None)."""
    header, base = read_header(path)
    with open(path, "rb") as f:
        for name, info in header.items():
            if name == "__metadata__":
                continue
            begin, end = info["data_offsets"]
            stored = _DTYPE_OF[info["dtype"]]
            buf = torch.empty(end - begin, dtype=torch.uint8)
            f.seek(base + begin)
            if end > begin and f.readinto(buf.numpy()) != end - begin:
                raise ValueError(f"{path}: {name} is cut short")
            t = buf.view(stored).reshape(info["shape"])
            if device is not None:
                t = t.to(device)
            yield name, t if dtype is None else t.to(dtype)


def load_file(path: str, dtype: torch.dtype | None = None,
              device=None) -> dict[str, torch.Tensor]:
    """Every tensor of `path` as a dict (see `read_tensors`)."""
    return dict(read_tensors(path, dtype, device))


def shard_paths(path_or_paths) -> list[str]:
    """One `.safetensors` file, a list of them, or a directory's
    `*.safetensors` (sorted by name) -> the list of files."""
    if isinstance(path_or_paths, str) and os.path.isdir(path_or_paths):
        paths = sorted(os.path.join(path_or_paths, f)
                       for f in os.listdir(path_or_paths)
                       if f.endswith(".safetensors"))
    elif isinstance(path_or_paths, str):
        paths = [path_or_paths]
    else:
        paths = list(path_or_paths)
    if not paths:
        raise FileNotFoundError(f"no .safetensors file in {path_or_paths}")
    return paths
