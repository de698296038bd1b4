"""Packed weight upload: one host->device copy a dtype group, then the
leaves cut out, dequantized and assembled on the device
(miotts_tpu/runtime/device_dequant.py).

``PackedLoader`` collects every weight leaf as host payloads: the GGUF's
own Q8_0/Q4_0 blocks or F16 halves where a leaf is a plain dense matmul
weight (``add_raw``), pre-cast bytes otherwise (``add_array``). ``finalize``
packs them into one flat host buffer a dtype (pinned on CUDA), copies each
buffer to the device once, and builds every leaf there: slice, view,
dequantize, reshape, transpose, concatenate. Each leaf is a tensor of its
own, allocated before the packed buffers (in the order the per-leaf route
allocates them) and filled from them, and the buffers are freed before
``finalize`` returns, so the weights hold as much device memory as the
per-leaf route's and no leaf keeps a buffer alive.

Numerics are those of the per-leaf route, bit for bit: dequant computes
f32(scale) * f32(int) and rounds once to the output dtype, and
``add_array`` leaves are pre-cast on the host exactly as
``models/llm.py weights_to_device`` casts them (bf16 as 16-bit words, by
torch's round to nearest even).

Streams. On CUDA everything runs on the device's default stream, which no
CUDA graph captures, so the pinned buffers' events (recorded when a buffer
is freed) never land in another thread's capture; ``finalize`` waits for
that stream, then frees the buffers. Nothing here synchronizes the whole
device.

The deploy artifact (``packed_artifact_path``, ``save_packed_artifact``,
``load_packed_artifact``) keeps the packed host buffers and the assembly
plan on disk, so a warm start replays one file read and one upload. Its
metadata is JSON (dtype names as strings, bf16 buffers as 16-bit words),
its signature carries ``ARTIFACT_TAG`` and its default directory is the
port's own, so the port and the JAX package never read each other's
artifacts.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import sys
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..gguf.quants import GGMLType

# raw GGUF payload kinds this module can expand on device
_SUPPORTED = (GGMLType.F16, GGMLType.Q8_0, GGMLType.Q4_0)
ARTIFACT_TAG = "miotts_tpu_torch"
_ARTIFACT_VERSION = 1
_ARTIFACT_SUFFIX = ".torch.packed.npz"

# dtype name -> (torch dtype, numpy dtype of its host words)
_DTYPES = {
    "float64": (torch.float64, np.float64), "float32": (torch.float32, np.float32),
    "float16": (torch.float16, np.float16), "bfloat16": (torch.bfloat16, np.int16),
    "int64": (torch.int64, np.int64), "int32": (torch.int32, np.int32),
    "int16": (torch.int16, np.int16), "int8": (torch.int8, np.int8),
    "uint8": (torch.uint8, np.uint8), "bool": (torch.bool, np.bool_),
}


def dtype_name(dtype) -> str:
    """The name of a torch or numpy dtype in ``_DTYPES``."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def device_dequant_enabled(device) -> bool:
    """On by default for a CUDA device, off for the CPU (where there is no
    copy to save); MIOTTS_DEVICE_DEQUANT=1/on or 0/off overrides either."""
    setting = os.environ.get("MIOTTS_DEVICE_DEQUANT", "")
    if setting in ("0", "off"):
        return False
    if setting in ("1", "on"):
        return True
    return torch.device(device).type == "cuda"


@dataclasses.dataclass
class UploadStats:
    """The last upload: its route ("per_leaf", "packed", "replay" or
    "fallback"), the host seconds packing, copying to the device and
    assembling there, and the bytes copied."""
    route: str = ""
    pack_s: float = 0.0
    copy_s: float = 0.0
    assemble_s: float = 0.0
    nbytes: int = 0


# routes taken in this process, and the last upload's stats
routes = {"per_leaf": 0, "packed": 0, "replay": 0, "fallback": 0}
last_upload = UploadStats()


def _record(stats: UploadStats) -> None:
    global last_upload
    routes[stats.route] += 1
    last_upload = stats


# ---------------------------------------------------------------------------
# the per-leaf route
# ---------------------------------------------------------------------------

def _flatten(tree: Any, out: list) -> Any:
    """Leaves of ``tree`` (nested dicts, lists, tuples; None kept) appended
    to ``out`` in traversal order; returns the tree's skeleton, whose
    leaves are their indices."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _flatten(v, out) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_flatten(v, out) for v in tree)
    out.append(tree)
    return len(out) - 1


def _unflatten(skeleton: Any, leaves: list) -> Any:
    if skeleton is None:
        return None
    if isinstance(skeleton, dict):
        return {k: _unflatten(v, leaves) for k, v in skeleton.items()}
    if isinstance(skeleton, (tuple, list)):
        return type(skeleton)(_unflatten(v, leaves) for v in skeleton)
    return leaves[skeleton]


def tree_to_device(tree: Any, device: torch.device) -> Any:
    """The per-leaf route: each numpy leaf copied on its own, dtype and
    shape kept (``ascontiguousarray`` would make a 0-d leaf 1-d)."""
    leaves: list = []
    skeleton = _flatten(tree, leaves)
    t0 = time.perf_counter()
    out = [a if isinstance(a, torch.Tensor) else
           torch.from_numpy(np.ascontiguousarray(a)).reshape(np.shape(a)).to(device)
           for a in leaves]
    _record(UploadStats("per_leaf", copy_s=time.perf_counter() - t0,
                        nbytes=sum(a.nbytes for a in leaves if not isinstance(a, torch.Tensor))))
    return _unflatten(skeleton, out)


def record_per_leaf(copy_s: float, nbytes: int) -> None:
    """A loader's own per-leaf upload (``models/llm.py``)."""
    _record(UploadStats("per_leaf", copy_s=copy_s, nbytes=nbytes))


# ---------------------------------------------------------------------------
# staging
# ---------------------------------------------------------------------------

def _raw_parts(reader, name: str):
    """(kind, shape, [host arrays]) for a supported tensor, else None.

    The arrays are compact copies, never views of the reader's mmap, so the
    reader can be closed while the packed buffer is still being built (a
    single-block tensor's slice is already contiguous: ``ascontiguousarray``
    would hand back a view)."""
    info = reader.tensors[name]
    kind = GGMLType(info.ggml_type)
    if kind not in _SUPPORTED:
        return None
    raw = np.asarray(reader.tensor_raw(name))
    if kind == GGMLType.F16:
        return "f16", info.shape, [raw.view(np.float16).reshape(info.shape).copy()]
    width = 34 if kind == GGMLType.Q8_0 else 18
    blocks = raw.reshape(-1, width)
    d = np.ascontiguousarray(blocks[:, :2]).view(np.float16)[:, 0].copy()
    q = blocks[:, 2:].copy()
    if kind == GGMLType.Q8_0:
        return "q8_0", info.shape, [d, q.view(np.int8)]
    return "q4_0", info.shape, [d, q]


def _dequant_segment(kind: str, shape, arrays, i: int):
    """One concatenation segment: dequantize (or widen) and reshape.
    Returns (f32 tensor, next array index)."""
    if kind == "f16":
        return arrays[i].float().reshape(shape), i + 1
    d, q = arrays[i], arrays[i + 1]
    if kind == "q4_0":  # nibbles biased by +8: the low 16, then the high 16 of a block
        q = torch.cat([(q & 0x0F).to(torch.int8) - 8, (q >> 4).to(torch.int8) - 8], dim=-1)
    # block payloads are row-major over the flat element order, so the flat
    # reshape is exact whatever the row length (gguf/quants.py's rule)
    return (q.float() * d.float()[..., None]).reshape(shape), i + 2


def _assemble_leaf(specs, transpose: bool, arrays) -> torch.Tensor:
    """A raw leaf at f32: each segment dequantized, transposed to [in, out]
    when asked, then concatenated along the last axis."""
    outs, i = [], 0
    for kind, shape in specs:
        x, i = _dequant_segment(kind, shape, arrays, i)
        outs.append(x.transpose(-1, -2) if transpose else x)
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


def _raw_out_shape(specs, transpose: bool) -> tuple:
    shapes = [tuple(s[:-2]) + (s[-1], s[-2]) if transpose else tuple(s) for _, s in specs]
    return shapes[0][:-1] + (sum(s[-1] for s in shapes),)


class _Pending:
    """What a loader holds for a leaf until ``PackedLoader.finalize``."""

    __slots__ = ("key",)

    def __init__(self, key):
        self.key = key


def _round_bf16_words(arr: np.ndarray) -> np.ndarray:
    """f32 values -> their bf16 words (round to nearest even), as int16."""
    t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy()


class PackedLoader:
    """Collect leaves -> one host buffer a dtype -> one copy each -> the
    leaves built on ``device``.

    ``add_raw`` stages a leaf assembled from raw GGUF payloads (None when a
    tensor's type is not Q8_0, Q4_0 or F16); ``add_array`` stages a host
    array, pre-cast to ``out_dtype`` as ``weights_to_device`` casts it.
    ``finalize`` returns {key: tensor}."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._parts: list = []  # host arrays, staging order
        self._part_dtype: list[str] = []
        self._shapes: list[tuple] = []
        # key -> {"kind": "arr", "parts": [i]}
        #      | {"kind": "raw", "parts": [...], "specs": ..., "transpose": b, "dtype": name}
        self._leaves: dict[Any, dict] = {}

    def _stage(self, arr: np.ndarray, name: str | None = None) -> int:
        self._parts.append(np.ascontiguousarray(arr))
        self._part_dtype.append(name or dtype_name(arr.dtype))
        self._shapes.append(tuple(int(s) for s in arr.shape))
        return len(self._parts) - 1

    def add_array(self, key, arr: np.ndarray, out_dtype: torch.dtype | None = None) -> _Pending:
        # a silently overwritten duplicate would leave its staged part behind
        assert key not in self._leaves, f"duplicate leaf key: {key!r}"
        if out_dtype == torch.bfloat16:
            idx = self._stage(_round_bf16_words(arr).reshape(np.shape(arr)), "bfloat16")
        else:
            arr = np.asarray(arr) if out_dtype is None else np.asarray(
                arr, dtype=_DTYPES[dtype_name(out_dtype)][1])
            idx = self._stage(arr)
        self._leaves[key] = {"kind": "arr", "parts": [idx]}
        return _Pending(key)

    def add_raw(self, key, reader, fmts: list[str], n_layers: int | None = None,
                transpose: bool = False, out_dtype: torch.dtype = torch.bfloat16
                ) -> _Pending | None:
        assert key not in self._leaves, f"duplicate leaf key: {key!r}"
        specs, staged = [], []
        for fmt in fmts:
            if n_layers is None:
                p = _raw_parts(reader, fmt)
                if p is None:
                    return None
                kind, shape, parts = p
            else:
                per = [_raw_parts(reader, fmt.format(i=i)) for i in range(n_layers)]
                if any(p is None for p in per):
                    return None
                kind, base_shape = per[0][0], per[0][1]
                if any(p[0] != kind or p[1] != base_shape for p in per):
                    return None
                shape = (n_layers,) + tuple(base_shape)
                parts = [np.stack([p[2][j] for p in per]) for j in range(len(per[0][2]))]
            specs.append((kind, tuple(int(s) for s in shape)))
            staged.extend(parts)
        self._leaves[key] = {"kind": "raw", "parts": [self._stage(a) for a in staged],
                             "specs": tuple(specs), "transpose": bool(transpose),
                             "dtype": dtype_name(out_dtype)}
        return _Pending(key)

    def finalize(self, artifact_path=None, extra_meta=None, order=None) -> dict:
        """Build every staged leaf on the device. ``order`` (keys) is the
        order in which the leaves are allocated: the per-leaf route's, so
        that the caching allocator hands out the same blocks (default:
        staging order). ``artifact_path`` also writes the packed buffers
        and the plan as a deploy artifact, with ``extra_meta``."""
        if not self._leaves:
            return {}
        t0 = time.perf_counter()
        group_names = list(dict.fromkeys(self._part_dtype))
        part_loc: list = [None] * len(self._parts)
        pinned = self.device.type == "cuda"
        host_groups, keep = [], []
        for g, name in enumerate(group_names):
            idxs = [i for i, n in enumerate(self._part_dtype) if n == name]
            total = sum(self._parts[i].size for i in idxs)
            buf, holder = _host_buffer(total, name, pinned)
            start = 0
            for i in idxs:
                n = self._parts[i].size
                buf[start:start + n] = self._parts[i].reshape(-1)
                part_loc[i] = (g, start, n)
                start += n
                # release the staged copy as it is packed: keeping every part
                # beside its packed copy would double the host's peak
                self._parts[i] = None
            host_groups.append(buf)
            keep.append(holder)
        keys = list(self._leaves) if order is None else list(order)
        assert len(keys) == len(self._leaves) and set(keys) == set(self._leaves), "bad order"
        meta = {"group_dtypes": group_names, "part_loc": part_loc, "part_shape": self._shapes,
                "part_dtype": self._part_dtype,
                "leaves": [[key, self._leaves[key]] for key in keys]}
        pack_s = time.perf_counter() - t0
        if artifact_path is not None:
            try:
                save_packed_artifact(artifact_path, host_groups, meta, extra_meta)
            except Exception as e:  # a full or read-only disk costs the artifact, not the load
                print(f"mio: packed-artifact save failed ({e!r})", file=sys.stderr)
        self._parts, self._part_dtype, self._shapes, self._leaves = [], [], [], {}
        return _assemble_groups(host_groups, meta, self.device, "packed", pack_s, keep)


def _host_buffer(n: int, name: str, pinned: bool):
    """A flat host buffer of ``n`` words of dtype ``name``: (numpy view, the
    pinned torch tensor behind it or None)."""
    if not pinned:
        return np.empty(n, _DTYPES[name][1]), None
    storage = torch.int16 if name == "bfloat16" else _DTYPES[name][0]
    t = torch.empty(n, dtype=storage, pin_memory=True)
    return t.numpy(), t


# ---------------------------------------------------------------------------
# assembly on the device
# ---------------------------------------------------------------------------

def _leaf_out(spec: dict, meta: dict) -> tuple[tuple, torch.dtype]:
    if spec["kind"] == "arr":
        i = spec["parts"][0]
        return tuple(meta["part_shape"][i]), _DTYPES[meta["part_dtype"][i]][0]
    return _raw_out_shape(spec["specs"], spec["transpose"]), _DTYPES[spec["dtype"]][0]


def _cut(bufs, meta: dict, i: int) -> torch.Tensor:
    g, start, n = meta["part_loc"][i]
    return bufs[g][start:start + n].view(tuple(meta["part_shape"][i]))


def _build(spec: dict, parts: list, out: torch.Tensor) -> None:
    """Fill ``out`` with one leaf from its parts, already on the device."""
    if spec["kind"] == "arr":
        out.copy_(parts[0])
    else:
        out.copy_(_assemble_leaf(spec["specs"], spec["transpose"], parts))


def _device_groups(host_groups, names, device, holders) -> list:
    """The packed host buffers copied to ``device`` (on CUDA from pinned
    memory, asynchronously on the current stream), each in its dtype (bf16
    travels as 16-bit words and is viewed back)."""
    out = []
    for host, name, pinned in zip(host_groups, names, holders):
        t = (pinned if pinned is not None else torch.from_numpy(host)).to(device,
                                                                           non_blocking=True)
        out.append(t.view(torch.bfloat16) if name == "bfloat16" else t)
    return out


def _assemble_groups(host_groups, meta, device, route: str, pack_s: float = 0.0,
                     holders=None) -> dict:
    """Copy the packed buffers to ``device`` and build every leaf there
    (the staging path's and the artifact replay's). Falls back to
    assembling leaf by leaf, each from its own small copies, when that
    fails."""
    holders = holders or [None] * len(host_groups)
    try:
        return _assemble_packed(host_groups, meta, device, route, pack_s, holders)
    except Exception as e:  # e.g. out of memory with buffers and leaves both resident
        error = repr(e)
    # outside the handler, so that the failed attempt's tensors are freed first
    print(f"mio: packed weight upload failed ({error}); falling back to per-leaf assembly",
          file=sys.stderr)
    return _assemble_per_leaf(host_groups, meta, device)


def _stream_ctx(device):
    """(context, stream): on CUDA the device's default stream, which no
    CUDA graph captures; nothing on the CPU."""
    if device.type != "cuda":
        return contextlib.nullcontext(), None
    stream = torch.cuda.default_stream(device)
    return torch.cuda.stream(stream), stream


def _assemble_packed(host_groups, meta, device, route, pack_s, holders) -> dict:
    ctx, stream = _stream_ctx(device)
    with ctx:
        outs = {}
        for key, spec in meta["leaves"]:  # allocated first, in the per-leaf route's order
            shape, dtype = _leaf_out(spec, meta)
            outs[key] = torch.empty(shape, dtype=dtype, device=device)
        t0 = time.perf_counter()
        if stream is not None:  # a replayed artifact's buffers are pinned here
            holders = [p if p is not None else torch.from_numpy(h).pin_memory()
                       for h, p in zip(host_groups, holders)]
        bufs = _device_groups(host_groups, meta["group_dtypes"], device, holders)
        if stream is not None:
            stream.synchronize()
        t1 = time.perf_counter()
        for key, spec in meta["leaves"]:
            _build(spec, [_cut(bufs, meta, j) for j in spec["parts"]], outs[key])
        if stream is not None:
            stream.synchronize()  # before the pinned buffers go back to their pool
        del bufs, holders
    _record(UploadStats(route, pack_s=pack_s, copy_s=t1 - t0,
                        assemble_s=time.perf_counter() - t1,
                        nbytes=sum(h.nbytes for h in host_groups)))
    return outs


def _assemble_per_leaf(host_groups, meta, device) -> dict:
    ctx, stream = _stream_ctx(device)
    t0, nbytes = time.perf_counter(), 0
    with ctx:
        outs = {}
        for key, spec in meta["leaves"]:
            # each part cut back out of its packed host buffer and copied alone
            parts = []
            for j in spec["parts"]:
                g, start, n = meta["part_loc"][j]
                seg = np.array(host_groups[g][start:start + n])
                nbytes += seg.nbytes
                t = torch.from_numpy(seg).to(device).view(tuple(meta["part_shape"][j]))
                parts.append(t.view(torch.bfloat16) if meta["part_dtype"][j] == "bfloat16"
                             else t)
            shape, dtype = _leaf_out(spec, meta)
            outs[key] = torch.empty(shape, dtype=dtype, device=device)
            _build(spec, parts, outs[key])
        if stream is not None:
            stream.synchronize()
    _record(UploadStats("fallback", copy_s=time.perf_counter() - t0, nbytes=nbytes))
    return outs


# ---------------------------------------------------------------------------
# deploy artifact: the packed host buffers and the assembly plan on disk.
# A warm start replays it with one file read and one upload, skipping the
# GGUF tensor reads, the host quantization and the packing of a first start.
# ---------------------------------------------------------------------------

def packed_artifact_path(src_path: str, sig: str) -> Path | None:
    """The deploy artifact for a source model and a load signature, or None.

    Opt-in (artifacts are model-sized): None unless MIOTTS_PACKED_CACHE is
    set; "1"/"on" picks ~/.cache/miotts_tpu_torch/packed, anything else is
    the directory. The server's entry point defaults it on. The name
    carries the source's path, size and mtime, the signature and
    ``ARTIFACT_TAG``, so a replaced model never replays a stale pack and
    the JAX package's artifacts (``*.packed.npz`` under its own signature)
    are never read."""
    setting = os.environ.get("MIOTTS_PACKED_CACHE", "")
    if setting in ("", "0", "off", "false"):
        return None
    base = (Path(os.path.expanduser("~")) / ".cache" / "miotts_tpu_torch" / "packed"
            if setting in ("1", "on") else Path(setting))
    try:
        st = os.stat(src_path)
    except OSError:
        return None
    ident = (f"{os.path.abspath(src_path)}|{st.st_size}|{int(st.st_mtime)}|{sig}|"
             f"{ARTIFACT_TAG}|v{_ARTIFACT_VERSION}")
    h = hashlib.sha256(ident.encode()).hexdigest()[:20]
    return base / f"{Path(src_path).stem}-{h}{_ARTIFACT_SUFFIX}"


def _tuples(x):
    """JSON's lists back to the tuples they were (keys, shapes, specs)."""
    if isinstance(x, list):
        return tuple(_tuples(v) for v in x)
    if isinstance(x, dict):
        return {k: _tuples(v) for k, v in x.items()}
    return x


def save_packed_artifact(path, host_groups, meta: dict, extra_meta=None) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"version": _ARTIFACT_VERSION, "tag": ARTIFACT_TAG, "meta": meta,
               "extra": extra_meta}
    blob = np.frombuffer(json.dumps(payload).encode(), np.uint8)
    tmp = path.with_name(path.name + ".tmp.npz")
    np.savez(tmp, meta_json=blob, **{f"g{i}": g for i, g in enumerate(host_groups)})
    os.replace(tmp, path)


def load_packed_artifact(path, device) -> tuple[dict, Any] | None:
    """Replay a deploy artifact on ``device`` -> (leaves, extra_meta), or
    None when the file is missing, unreadable or of another version or tag.
    Prints one stderr line: the read's seconds against the assembly's and
    upload's, and the host bytes."""
    t0 = time.perf_counter()
    try:
        with np.load(path) as z:
            payload = json.loads(bytes(z["meta_json"]).decode())
            if payload.get("version") != _ARTIFACT_VERSION or payload.get("tag") != ARTIFACT_TAG:
                return None
            meta = payload["meta"]
            host_groups = [z[f"g{i}"] for i in range(len(meta["group_dtypes"]))]
    except Exception:
        return None
    meta = {"group_dtypes": meta["group_dtypes"], "part_loc": _tuples(meta["part_loc"]),
            "part_shape": _tuples(meta["part_shape"]), "part_dtype": meta["part_dtype"],
            "leaves": [(_tuples(key), {k: _tuples(v) for k, v in spec.items()})
                       for key, spec in meta["leaves"]]}
    t_read = time.perf_counter() - t0
    t1 = time.perf_counter()
    built = _assemble_groups(host_groups, meta, torch.device(device), "replay")
    print(f"mio: packed artifact replay: read {t_read:.1f}s + assemble/upload "
          f"{time.perf_counter() - t1:.1f}s "
          f"({sum(g.nbytes for g in host_groups) / 1e6:.0f} MB host bytes)", file=sys.stderr)
    extra = payload.get("extra")
    return built, (None if extra is None else _tuples(extra))


def build_leaf(reader, fmts: list[str], device, n_layers: int | None = None,
               transpose: bool = False, dtype: torch.dtype = torch.bfloat16):
    """One leaf built now from its raw payloads on ``device``; None when a
    tensor's type is not Q8_0, Q4_0 or F16."""
    pk = PackedLoader(device)
    if pk.add_raw("leaf", reader, fmts, n_layers, transpose, dtype) is None:
        return None
    return pk.finalize()["leaf"]


def device_put_packed(tree: Any, device, sharding=None) -> Any:
    """``tree_to_device`` with one copy a dtype (native dtypes kept) where
    ``device_dequant_enabled``; tensors already placed pass through.

    ``sharding`` (the JAX package's argument, there a mesh-replicated
    placement): a sequence of logical devices (``parallel/mesh.py``
    ``Device``, e.g. an sp mesh's), on each of which the tree is wanted;
    returns one tree for each, placed once for each physical device and
    shared by the logical devices on it. ``device`` is then unused."""
    if sharding is not None:
        from ..parallel.mesh import same_device

        placed: list = []
        out = []
        for d in sharding:
            tree_d = next((t for dev, t in placed if same_device(dev, d.device)), None)
            if tree_d is None:
                tree_d = device_put_packed(tree, d.device)
                placed.append((d.device, tree_d))
            out.append(tree_d)
        return out
    device = torch.device(device)
    if not device_dequant_enabled(device):
        return tree_to_device(tree, device)
    leaves: list = []
    skeleton = _flatten(tree, leaves)
    pk = PackedLoader(device)
    for i, leaf in enumerate(leaves):
        if not isinstance(leaf, torch.Tensor):
            pk.add_array(i, np.asarray(leaf))
    built = pk.finalize()
    return _unflatten(skeleton, [built.get(i, leaf) for i, leaf in enumerate(leaves)])
