"""Device meshes and sharding rules for multi-device serving and
sequence-parallel decodes (miotts_tpu/parallel/mesh.py).

Axes, as in the JAX package:

- ``dp``: request fan-out. The server's batch lanes and codec
  micro-batches split over it, a contiguous block of lanes a rank.
- ``tp``: tensor parallelism for the LLM, Megatron-style: q/k/v and
  gate/up column-parallel, attention-out and down row-parallel (each
  followed by a sum over the group), the embedding and the logits head
  split over the vocab where it divides.
- ``sp`` (``make_sp_mesh``, a 1-D mesh of its own): one codec decode's
  time axis split over the ranks (``parallel/sequence.py``), the codec's
  weights replicated on each.

The JAX package leaves the placement of every leaf to GSPMD. Here a
sharding is explicit: ``shard_llm_weights`` returns one ``TPGroup`` a dp
rank, holding one weight dict for each of its tp ranks, each placed on its
rank's device. A rank holds whole heads: rank r of tp takes query heads
[r H/tp, (r+1) H/tp) and the kv heads they read, kv heads replicated where
tp > n_kv_heads; a fused q|k|v or gate|up leaf is rebuilt a rank as its own
[q_r | k_r | v_r] and [gate_r | up_r] (quantization is per column, so a
column slice of a quantized leaf is exact).

A device here is logical: ``logical_devices`` gives one rank for each
physical device of the platform, or, with ``MIOTTS_LOGICAL_DEVICES=n``, n
ranks on the platform's first device (the port's counterpart of the JAX
suite's ``--xla_force_host_platform_device_count``). It changes how many
ranks exist, never what a rank computes.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Any

import numpy as np
import torch

LOGICAL_ENV = "MIOTTS_LOGICAL_DEVICES"
_announced = False


def P(*axes):
    """A partition spec: the mesh axis each array axis splits over, or None."""
    return tuple(axes)


@dataclasses.dataclass(frozen=True)
class Device:
    """One logical device, named ``platform:id``, on the torch device
    ``device`` (which several logical devices may share)."""
    platform: str
    id: int
    device: torch.device

    def __str__(self) -> str:
        return f"{self.platform}:{self.id}"


def logical_devices(platform: str | None = None) -> list[Device]:
    """The platform's devices (``MIOTTS_PLATFORM`` by default, cuda or cpu)
    as mesh ranks: one for each physical device (``cuda:i``, the CPU as
    ``cpu:0``), or ``MIOTTS_LOGICAL_DEVICES`` ranks on the first one."""
    global _announced
    if platform is None:
        platform = os.environ.get("MIOTTS_PLATFORM", "") or "cuda"
    platform = platform.lower()
    if platform == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("MIOTTS_PLATFORM=cuda but torch.cuda.is_available() is False")
        physical = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    elif platform == "cpu":
        physical = [torch.device("cpu")]
    else:
        raise ValueError(f"no devices for platform {platform!r}")
    n = os.environ.get(LOGICAL_ENV, "").strip()
    if not n:
        return [Device(platform, i, d) for i, d in enumerate(physical)]
    count = int(n)
    if count < 1:
        raise ValueError(f"{LOGICAL_ENV} must be at least 1, got {count}")
    if platform == "cuda" and not _announced:
        _announced = True
        print(f"mio: {LOGICAL_ENV}={count}: {count} logical devices on {physical[0]}",
              file=sys.stderr)
    return [Device(platform, i, physical[0]) for i in range(count)]


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two torch devices are one physical device (``cuda`` naming the
    current card)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == (cur if b.index is None else b.index)


class Mesh:
    """A (dp, tp) grid of logical devices: ``devices`` is an object array
    shaped (dp, tp), ``shape`` maps each axis name to its size."""

    axis_names = ("dp", "tp")

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        names = [[str(d) for d in row] for row in self.devices]
        return f"Mesh({self.shape}, {names})"


class SpMesh(Mesh):
    """A 1-D ("sp",) mesh: ``devices`` an object array of its ranks, the
    first of them its lead."""

    axis_names = ("sp",)

    def __repr__(self) -> str:
        return f"SpMesh({self.shape}, {[str(d) for d in self.devices]})"

    @property
    def lead(self) -> torch.device:
        return self.devices[0].device

    @property
    def one_device(self) -> bool:
        """Every rank on the lead's physical device (so a decode over the
        mesh can be captured as one CUDA graph)."""
        return all(same_device(d.device, self.lead) for d in self.devices)


def make_sp_mesh(devices=None, sp: int | None = None) -> SpMesh:
    """The 1-D ("sp",) mesh of a sequence-parallel codec decode over the
    first ``sp`` of ``devices`` (default: all of ``logical_devices()``).
    Asking for more ranks than devices raises, as in the JAX package."""
    if devices is None:
        devices = logical_devices()
    devices = list(devices)
    if sp is not None:
        if sp > len(devices):
            raise ValueError(f"sp={sp} > {len(devices)} devices")
        devices = devices[:sp]
    if len(set(devices)) != len(devices):
        raise ValueError(f"a device appears twice in {[str(d) for d in devices]}")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return SpMesh(arr)


def make_mesh(devices=None, dp: int | None = None, tp: int | None = None) -> Mesh:
    """Build a (dp, tp) mesh. Defaults: tp=1, dp=all devices."""
    if devices is None:
        devices = logical_devices()
    devices = list(devices)
    n = len(devices)
    if tp is None:
        tp = 1
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp ({dp}*{tp}) != n_devices ({n})")
    if len(set(devices)) != n:
        raise ValueError(f"a device appears twice in {[str(d) for d in devices]}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(dp, tp))


def parse_backend_devices(spec: str, platform: str | None = None):
    """Resolve the ``--mio-backend-devices`` flag to a device list. Accepted
    forms:
      ""            -> None (single default device)
      "all"         -> every visible device
      "0,2,3"       -> devices by index (a single "2" is index 2, not a
                       count)
      "cuda:0,cpu:1"-> devices by platform:id name (case-insensitive)
    A device named twice is an error."""
    spec = (spec or "").strip()
    if not spec:
        return None
    devices = logical_devices(platform)
    if spec.lower() == "all":
        return list(devices)
    parts = [p.strip() for p in spec.split(",") if p.strip()]
    out: list[Device] = []
    by_name = {str(d).lower(): d for d in devices}
    for p in parts:
        if p.isdigit():
            i = int(p)
            if i >= len(devices):
                raise ValueError(f"device index {i} out of range ({len(devices)} visible)")
            d = devices[i]
        elif p.lower() in by_name:
            d = by_name[p.lower()]
        else:
            raise ValueError(f"unknown device {p!r}; visible: {sorted(by_name)}")
        if d in out:
            raise ValueError(f"device {d} named twice in {spec!r}")
        out.append(d)
    return out


def tree_to(tree: Any, device: torch.device) -> Any:
    """Every tensor of a nested dict/list/tuple on ``device`` (a tensor there
    already is kept, not copied)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree


def replicate_tree(mesh: Mesh, tree: Any) -> list:
    """The tree on every rank of the mesh (in dp-major order): one tree a
    rank, copied once for each physical device, shared by the logical ranks
    on it."""
    placed: dict = {}
    out = []
    for d in mesh.devices.reshape(-1):
        key = next((k for k in placed if same_device(k, d.device)), None)
        if key is None:
            key = d.device
            placed[key] = tree_to(tree, key)
        out.append(placed[key])
    return out


# ---------------------------------------------------------------------------
# the LLM's sharding rules
# ---------------------------------------------------------------------------

_PAYLOAD = ("q", "q8", "q4i8", "q4")


def _vocab_axis_specs(mesh: Mesh, weights: Any) -> tuple:
    """(token_embd_spec, output_spec): shard the vocab axis over tp where it
    divides. The port's dense head is [V, D] (token-major) and a quantized
    head a [D, V]-derived leaf; the vocab axis is told from the dim (from
    attn_norm [L, D]). A vocab that tp does not divide (tiny test models)
    stays replicated."""
    tp = mesh.shape.get("tp", 1)
    embd = weights.get("token_embd")
    an = weights.get("attn_norm")
    dim = None if an is None else an.shape[-1]
    embd_spec = P(None, None)
    if tp > 1 and embd is not None and not isinstance(embd, dict):
        if embd.shape[0] % tp == 0 and embd.shape[0] != embd.shape[1]:
            embd_spec = P("tp", None)  # [V, D]
    ow = weights.get("output")
    out_spec = P(None, None)
    if tp > 1 and ow is not None:
        if isinstance(ow, dict):  # quant leaves are [D, V]-derived
            payload = [ow[k] for k in ("q8", "q4i8", "q4", "q") if k in ow]
            if not payload:
                raise ValueError(f"unrecognized quantized head leaf keys {sorted(ow)}")
            if payload[0].shape[-1] % tp == 0:
                out_spec = P(None, "tp")
        else:
            a, b = ow.shape
            if a != b and dim is not None:
                if b == dim and a % tp == 0:      # token-major [V, D]
                    out_spec = P("tp", None)
                elif a == dim and b % tp == 0:    # feature-major [D, V]
                    out_spec = P(None, "tp")
    return embd_spec, out_spec


_SPECS = {
    "attn_norm": P(None, None),
    "wq": P(None, None, "tp"),         # [L, D, H*hd] column-parallel
    "wk": P(None, None, "tp"),
    "wv": P(None, None, "tp"),
    "wqkv": P(None, None, "tp"),       # fused [L, D, (H+2KV)*hd]
    "wo": P(None, "tp", None),         # [L, H*hd, D] row-parallel
    "ffn_norm": P(None, None),
    "w_gate": P(None, None, "tp"),     # [L, D, FF]
    "w_up": P(None, None, "tp"),
    "w_gateup": P(None, None, "tp"),   # fused [L, D, 2*FF]
    "w_down": P(None, "tp", None),     # [L, FF, D]
    "bq": P(None, "tp"),
    "bk": P(None, "tp"),
    "bv": P(None, "tp"),
    "bqkv": P(None, "tp"),
    "q_norm": P(None, None),
    "k_norm": P(None, None),
    "output_norm": P(None),
}


def llm_weight_shardings(mesh: Mesh, weights: Any) -> Any:
    """The partition spec of every leaf of the LLM weight dict
    (models/llm.py layout: stacked [n_layers, ...], matmul weights [in,
    out]). A quantized leaf's payload shards like the dense weight, a Q8_0
    scale ``s`` ([..., K/32, N]) too, and a per-column scale ``s8``/``s4``
    drops the K axis: P(l, k, n) -> P(l, n)."""
    embd_spec, out_spec = _vocab_axis_specs(mesh, weights)
    specs = dict(_SPECS, token_embd=embd_spec, output=out_spec)

    def leaf_specs(k, v):
        spec = specs[k]
        if not isinstance(v, dict):
            return spec
        out = {}
        for name in v:
            if name in _PAYLOAD or name == "s":
                out[name] = spec
            elif name in ("s8", "s4"):
                out[name] = P(*spec[:-2], spec[-1])
            else:  # pragma: no cover - future leaf kinds stay replicated
                out[name] = P()
        return out

    return {k: (None if v is None else leaf_specs(k, v)) for k, v in weights.items()}


def llm_data_shardings(mesh: Mesh) -> dict:
    """Specs of activations and caches: batch lanes over dp, KV heads over tp."""
    return {
        "tokens": P("dp", None),
        "lengths": P("dp"),
        "cache": P(None, "dp", None, "tp", None),
        "logits": P("dp", None),
    }


def rank_config(cfg, tp: int):
    """A tp rank's view of the LLM config: its query heads, its kv heads
    (one where tp > n_kv_heads) and its slice of the ffn."""
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                               n_kv_heads=max(1, cfg.n_kv_heads // tp),
                               ffn_dim=cfg.ffn_dim // tp)


def kv_heads(cfg, tp: int, r: int) -> list[int]:
    """The kv heads tp rank r holds: its share where tp divides them, else
    the one head its query heads read (replicated over tp / n_kv_heads
    ranks)."""
    KVH = cfg.n_kv_heads
    if KVH >= tp:
        per = KVH // tp
        return list(range(r * per, (r + 1) * per))
    return [r * KVH // tp]


def _check_split(cfg, tp: int) -> None:
    H, KVH, F = cfg.n_heads, cfg.n_kv_heads, cfg.ffn_dim
    if H % tp or F % tp or (KVH % tp and tp % KVH):
        raise ValueError(f"--tensor-parallel {tp} does not split the LLM's {H} heads, "
                         f"{KVH} kv heads and {F} ffn columns into whole heads a rank")


def _rank_index(cfg, tp: int, r: int) -> dict[str, np.ndarray]:
    """Rank r's columns (or rows) of each projection, as index arrays."""
    hd, Hr, Fr = cfg.head_dim, cfg.n_heads // tp, cfg.ffn_dim // tp
    Hd, KVd = cfg.n_heads * hd, cfg.n_kv_heads * hd
    q = np.arange(r * Hr * hd, (r + 1) * Hr * hd)
    kv = np.concatenate([h * hd + np.arange(hd) for h in kv_heads(cfg, tp, r)])
    ff = np.arange(r * Fr, (r + 1) * Fr)
    return {"q": q, "kv": kv, "qkv": np.concatenate([q, Hd + kv, Hd + KVd + kv]),
            "ff": ff, "gateup": np.concatenate([ff, cfg.ffn_dim + ff])}


# leaf -> (axis kind, index name): "col" slices the last axis, "row" the K
# axis of a [L, K, N] leaf
_TP_LEAVES = {
    "wqkv": ("col", "qkv"), "bqkv": ("col", "qkv"),
    "wq": ("col", "q"), "bq": ("col", "q"),
    "wk": ("col", "kv"), "wv": ("col", "kv"), "bk": ("col", "kv"), "bv": ("col", "kv"),
    "w_gateup": ("col", "gateup"), "w_gate": ("col", "ff"), "w_up": ("col", "ff"),
    "wo": ("row", "q"), "w_down": ("row", "ff"),
}


def _cols(t: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    return t.index_select(-1, torch.as_tensor(idx, dtype=torch.int64, device=t.device))


def _rows(leaf, idx: np.ndarray):
    """Rows [idx[0], idx[-1]] (a contiguous range) of a [L, K, N] leaf; a
    Q8_0 scale by its 32-row blocks, a per-column scale whole."""
    start, n = int(idx[0]), len(idx)
    if not isinstance(leaf, dict):
        return leaf.narrow(-2, start, n).contiguous()
    out = {}
    for name, a in leaf.items():
        if name == "s":
            out[name] = a.narrow(-2, start // 32, n // 32).contiguous()
        elif name in ("s8", "s4"):
            out[name] = a
        else:
            out[name] = a.narrow(-2, start, n).contiguous()
    return out


def _vocab_part(leaf, axis: int, tp: int, r: int):
    if isinstance(leaf, dict):  # a quantized head [D, Np]: every sub-leaf by column
        return {k: _vocab_part(a, -1, tp, r) for k, a in leaf.items()}
    n = leaf.shape[axis] // tp
    return leaf.narrow(axis, r * n, n).contiguous()


def _check_kernel_rules(name: str, leaf, tp: int) -> None:
    """A quantized rank leaf must fit the kernel that multiplies it: K3 (a
    Q8_0 leaf) needs K % 32 == 0 and N % 4 == 0, ``torch._int_mm`` (W8A8,
    W4A8) K % 8 == 0 and N % 8 == 0."""
    if not isinstance(leaf, dict):
        return
    key = next(k for k in _PAYLOAD if k in leaf)
    K, N = leaf[key].shape[-2:]
    kmod, nmod, kernel = (32, 4, "K3's") if key == "q" else (8, 8, "torch._int_mm's")
    if K % kmod or N % nmod:
        raise ValueError(f"--tensor-parallel {tp}: the {name} shard of a rank is [K={K}, "
                         f"N={N}], which breaks {kernel} rule K % {kmod} == 0 and "
                         f"N % {nmod} == 0")


def _split_axis(spec) -> int | None:
    """The axis a leaf's spec (its payload's, for a quantized leaf) splits
    over tp, or None."""
    if isinstance(spec, dict):
        spec = spec[next(k for k in _PAYLOAD if k in spec)]
    return spec.index("tp") if spec and "tp" in spec else None


def _rank_leaf(name: str, leaf, spec, tp: int, r: int, index: dict):
    if leaf is None:
        return None
    if name in _TP_LEAVES:
        kind, which = _TP_LEAVES[name]
        idx = index[which]
        if kind == "row":
            return _rows(leaf, idx)
        if isinstance(leaf, dict):
            return {k: _cols(a, idx) for k, a in leaf.items()}
        return _cols(leaf, idx)
    axis = _split_axis(spec)
    if axis is not None:  # the vocab-split embedding or head
        return _vocab_part(leaf, axis, tp, r)
    return leaf


class TPGroup:
    """One dp rank's tensor-parallel group: ``shards[r]`` is tp rank r's
    weight dict, on ``devices[r]``; ``cfgs[r]`` its view of the config
    (``rank_config``). ``embd_split``/``head_split`` say whether the
    embedding and the logits head are split over the vocab (else rank 0's
    copy serves alone). ``one_device``: every rank on the lead's physical
    device, so a chunk of the group can be captured as one CUDA graph."""

    def __init__(self, cfg, shards: list[dict], ranks: list[Device], embd_split: bool,
                 head_split: bool):
        self.cfg = cfg
        self.shards = shards
        self.ranks = ranks
        self.tp = len(shards)
        self.devices = [d.device for d in ranks]
        self.lead = self.devices[0]
        self.cfgs = [rank_config(cfg, self.tp)] * self.tp
        self.embd_split = embd_split
        self.head_split = head_split
        self.one_device = all(same_device(d, self.lead) for d in self.devices)

    def __repr__(self) -> str:
        return f"TPGroup(tp={self.tp}, ranks={[str(d) for d in self.ranks]})"


def shard_llm_weights(mesh: Mesh, weights: Any, cfg) -> list[TPGroup]:
    """The LLM weights split over the mesh's tp axis (Megatron-style, by
    ``llm_weight_shardings``' specs): one ``TPGroup`` a dp rank, each rank's
    leaves on its device. Rank leaves are built once for each (tp rank,
    physical device) and shared by the dp ranks on that device. Raises
    where tp does not split the heads and the ffn into whole parts, or a
    quantized shard breaks its kernel's shape rules."""
    tp = mesh.shape["tp"]
    _check_split(cfg, tp)
    specs = llm_weight_shardings(mesh, weights)
    embd_split = _split_axis(specs["token_embd"]) is not None
    # a tied head is the embedding
    head_split = (embd_split if weights.get("output") is None
                  else _split_axis(specs["output"]) is not None)
    built: dict = {}
    groups = []
    for row in mesh.devices:
        shards = []
        for r, dev in enumerate(row):
            key = next((k for k in built if k[0] == r and same_device(k[1], dev.device)), None)
            if key is None:
                index = _rank_index(cfg, tp, r)
                shard = {}
                for name, leaf in weights.items():
                    part = _rank_leaf(name, leaf, specs[name], tp, r, index)
                    if tp > 1:
                        _check_kernel_rules(name, part, tp)
                    shard[name] = tree_to(part, dev.device)
                key = (r, dev.device)
                built[key] = shard
            shards.append(built[key])
        groups.append(TPGroup(cfg, shards, list(row), embd_split, head_split))
    return groups


def gen_state_shardings(mesh: Mesh) -> dict:
    """Specs of a batched GenState (models/llm.py): lanes over dp, KV heads
    over tp."""
    return {
        "logits": P("dp", None),
        "cache_k": P(None, "dp", None, "tp", None),
        "cache_v": P(None, "dp", None, "tp", None),
        "pos": P("dp"),
        "ring": P("dp", None),
        "ring_idx": P(),
        "done": P("dp"),
        "key": P("dp", None),
    }


def _own(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A copy of ``t`` of its own, contiguous, on ``device``."""
    return t.to(device, copy=True).contiguous()


def shard_gen_state(mesh: Mesh, state, groups: list) -> list:
    """A batched GenState split over the mesh (``gen_state_shardings``): one
    state a dp rank (a contiguous block of lanes) on its group's lead
    device, its KV cache a tuple of tp parts (tp rank r's kv heads, on its
    device) where the group is a ``TPGroup`` of tp > 1, else one tensor.
    ``groups[d]`` is dp rank d's weights (a ``TPGroup`` or a weight dict)."""
    dp = mesh.shape["dp"]
    B = state.pos.shape[0]
    if B % dp:
        raise ValueError(f"{B} lanes do not split over dp={dp}")
    per = B // dp
    out = []
    for d in range(dp):
        g = groups[d]
        lead = mesh.devices[d, 0].device
        sl = slice(d * per, (d + 1) * per)
        fields = {}
        for f in dataclasses.fields(state):
            t = getattr(state, f.name)
            if f.name in ("cache_k", "cache_v"):
                lanes = t[:, sl]
                if isinstance(g, TPGroup) and g.tp > 1:
                    fields[f.name] = tuple(
                        _own(lanes.index_select(3, torch.as_tensor(
                            kv_heads(g.cfg, g.tp, r), device=t.device)), dev)
                        for r, dev in enumerate(g.devices))
                else:
                    fields[f.name] = _own(lanes, lead)
            elif f.name == "ring_idx":
                fields[f.name] = _own(t, lead)
            else:
                fields[f.name] = _own(t[sl], lead)
        out.append(type(state)(**fields))
    return out


def codec_data_sharding(mesh: Mesh):
    """The codec's batch splits over lanes only (dp); its weights replicate."""
    return P("dp", None)
