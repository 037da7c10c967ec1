"""Checkpoint save / load (counterpart of ``da3slam_tpu/models/weights.py``)
and the port's own reader and writer of the safetensors format.

A checkpoint directory holds ``model.safetensors`` and ``config.json``.  Two
key layouts exist: the JAX package's native one, ``/``-joined pytree paths
(lists indexed numerically), and the torch-style one, dot-joined module names
(the port's ``state_dict``).  ``flatten_params`` maps a pytree to the first;
a state dict is already flat, so ``save_checkpoint`` writes either.

The safetensors file format, written and read here with numpy alone: 8 bytes
of little-endian header length, a JSON header mapping each name to its
``dtype``, ``shape`` and ``data_offsets`` into the body (plus an optional
``__metadata__`` entry), then the tensors' raw little-endian bytes.  BF16 has
no numpy type: it crosses through a 16-bit view.
"""

from __future__ import annotations

import dataclasses
import json
import struct
from pathlib import Path
from typing import Any

import numpy as np
import torch

from da3slam_tpu_torch.models.config import ModelConfig, config_from_json

# safetensors dtype name -> (numpy dtype of the stored bytes, torch dtype)
_DTYPES = {
    "F32": ("<f4", torch.float32),
    "F16": ("<f2", torch.float16),
    "BF16": ("<i2", torch.bfloat16),
    "I8": ("i1", torch.int8),
    "I32": ("<i4", torch.int32),
    "I64": ("<i8", torch.int64),
    "U8": ("u1", torch.uint8),
    "BOOL": ("?", torch.bool),
}
_NAMES = {t: name for name, (_, t) in _DTYPES.items()}


def save_file(tensors: dict[str, Any], path: str | Path) -> None:
    """Write ``{name: tensor or numpy array}`` as one safetensors file."""
    header: dict[str, Any] = {}
    chunks: list[bytes] = []
    offset = 0
    for name in sorted(tensors):
        t = torch.as_tensor(tensors[name]).detach().cpu().contiguous()
        if t.dtype not in _NAMES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors name here")
        st = _NAMES[t.dtype]
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        data = raw.numpy().astype(_DTYPES[st][0], copy=False).tobytes()
        header[name] = {"dtype": st, "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        chunks.append(data)
        offset += len(data)
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)  # the body starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for data in chunks:
            f.write(data)


def load_file(path: str | Path) -> dict[str, torch.Tensor]:
    """Read a safetensors file into ``{name: CPU tensor}``.  A file that is
    cut short, or whose header is not what the format says, raises
    ``ValueError``."""
    raw = Path(path).read_bytes()
    if len(raw) < 8:
        raise ValueError(f"{path}: shorter than the 8-byte header length")
    (n,) = struct.unpack("<Q", raw[:8])
    if n > len(raw) - 8:
        raise ValueError(f"{path}: header length {n} exceeds the file ({len(raw)} bytes)")
    try:
        header = json.loads(raw[8:8 + n].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: the header is not JSON: {e}") from None
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is not a JSON object")
    body = memoryview(raw)[8 + n:]
    out: dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        try:
            np_dtype, t_dtype = _DTYPES[info["dtype"]]
            shape = tuple(int(d) for d in info["shape"])
            lo, hi = (int(x) for x in info["data_offsets"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"{path}: bad header entry for {name!r}: {e!r}") from None
        count = int(np.prod(shape, dtype=np.int64))
        if not 0 <= lo <= hi <= len(body) or hi - lo != count * np.dtype(np_dtype).itemsize:
            raise ValueError(f"{path}: {name!r} spans bytes [{lo}, {hi}) of a {len(body)}-byte "
                             f"body, for {count} values of {info['dtype']}")
        arr = np.frombuffer(body[lo:hi], dtype=np_dtype).reshape(shape).copy()
        t = torch.from_numpy(arr)
        out[name] = t.view(torch.bfloat16) if t_dtype == torch.bfloat16 else t
    return out


def flatten_params(params: Any, prefix: str = "") -> dict[str, Any]:
    """A nested dict / list pytree → ``{"/"-joined path: leaf}``."""
    out: dict[str, Any] = {}
    if isinstance(params, dict):
        for k, v in params.items():
            out.update(flatten_params(v, f"{prefix}{k}/"))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            out.update(flatten_params(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = params
    return out


def unflatten_params(flat: dict[str, Any]) -> Any:
    """Rebuild the nested structure; integer-keyed levels become lists."""
    tree: dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def materialise(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [materialise(node[str(i)]) for i in range(len(node))]
        return {k: materialise(v) for k, v in node.items()}

    return materialise(tree)


def save_checkpoint(path: str | Path, params: Any, cfg: ModelConfig) -> None:
    """Write ``model.safetensors`` + ``config.json`` into directory ``path``.
    ``params`` is a pytree (written ``/``-joined) or a state dict (written as
    it is named)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    save_file(flatten_params(params), path / "model.safetensors")
    (path / "config.json").write_text(json.dumps(dataclasses.asdict(cfg), indent=2))


def load_checkpoint(path: str | Path) -> tuple[Any, ModelConfig]:
    """``(params, cfg)`` of a directory that ``save_checkpoint`` wrote: the
    pytree of CPU tensors for the ``/``-joined layout, the flat state dict for
    the dot-named one."""
    path = Path(path)
    cfg = config_from_json(path / "config.json")
    return unflatten_params(load_file(path / "model.safetensors")), cfg
