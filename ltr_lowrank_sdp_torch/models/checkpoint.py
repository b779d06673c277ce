"""Checkpoints of the rank predictor: Flax msgpack + config.json.

The counterpart of ``ltr_lowrank_sdp_tpu/models/checkpoint.py``: the same
checkpoint directories (``runs/*/model.msgpack`` and ``config.json``) load
into the port's :class:`~.net.RankSchedulePredictor`, and the port writes
them.  Neither ``flax`` nor ``msgpack`` is needed: :func:`read_flax_msgpack`
reads the subset of msgpack that ``flax.serialization.to_bytes`` writes and
:func:`write_flax_msgpack` writes it, byte for byte as Flax does;
:func:`params_from_flax` maps the Flax parameter tree onto the port's
``state_dict`` and :func:`params_to_flax` back.  Every leaf becomes float32,
as the JAX loader normalises them.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from .net import ModelConfig, RankSchedulePredictor

# flax.serialization's msgpack extension type of an ndarray
_EXT_NDARRAY = 1
_MSGPACK_CHUNK_LIMIT = 2 ** 30   # flax splits a larger array into chunks


class _Reader:
    """A big-endian msgpack decoder for maps, arrays, str, bin, ints,
    floats, nil / bool and Flax's ndarray ext values (the subset that
    ``flax.serialization.to_bytes`` writes for a parameter tree)."""

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends early")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        t = self.unpack("B")
        if t <= 0x7f:
            return t
        if t >= 0xe0:
            return t - 0x100
        if 0x80 <= t <= 0x8f:
            return self.map(t & 0x0f)
        if 0x90 <= t <= 0x9f:
            return self.array(t & 0x0f)
        if 0xa0 <= t <= 0xbf:
            return str(self.take(t & 0x1f), "utf-8")
        fixed = {0xc0: None, 0xc2: False, 0xc3: True}
        if t in fixed:
            return fixed[t]
        scalar = {0xca: "f", 0xcb: "d", 0xcc: "B", 0xcd: "H", 0xce: "I",
                  0xcf: "Q", 0xd0: "b", 0xd1: "h", 0xd2: "i", 0xd3: "q"}
        if t in scalar:
            return self.unpack(scalar[t])
        sized = {0xc4: "B", 0xc5: "H", 0xc6: "I",        # bin
                 0xd9: "B", 0xda: "H", 0xdb: "I",        # str
                 0xdc: "H", 0xdd: "I",                   # array
                 0xde: "H", 0xdf: "I",                   # map
                 0xc7: "B", 0xc8: "H", 0xc9: "I"}        # ext
        if t in sized:
            n = self.unpack(sized[t])
            if t in (0xc4, 0xc5, 0xc6):
                return bytes(self.take(n))
            if t in (0xd9, 0xda, 0xdb):
                return str(self.take(n), "utf-8")
            if t in (0xdc, 0xdd):
                return self.array(n)
            if t in (0xde, 0xdf):
                return self.map(n)
            return self.ext(n)
        if 0xd4 <= t <= 0xd8:
            return self.ext(1 << (t - 0xd4))
        raise ValueError(f"msgpack type byte {t:#04x} is not supported")

    def array(self, n: int):
        return [self.value() for _ in range(n)]

    def map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        data = bytes(self.take(n))
        if code != _EXT_NDARRAY:
            raise ValueError(f"msgpack ext type {code} is not supported")
        # a packed (shape, dtype name, C-order bytes)
        shape, dtype, buf = _Reader(data).value()
        return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()


def read_flax_msgpack(path_or_bytes) -> dict:
    """The state tree that ``flax.serialization.msgpack_restore`` returns,
    with ndarray leaves as numpy arrays."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(data):
        raise ValueError("trailing bytes after the msgpack value")
    return tree


class _Writer:
    """The msgpack encoder of ``msgpack.packb(..., use_bin_type=True)`` for
    the values a Flax parameter tree holds: dicts with str keys, ndarray
    leaves (as Flax's ext type 1 of a packed (shape, dtype name, C-order
    bytes)), and inside those tuples, ints, str and bytes."""

    def __init__(self):
        self.out = bytearray()

    def put(self, fmt: str, *vals) -> None:
        self.out += struct.pack(">" + fmt, *vals)

    def sized(self, n: int, small, codes) -> None:
        """A length header: the fix form ``small | n`` when ``small`` is
        given and fits, else the smallest of ``codes`` (8, 16, 32 bits)."""
        fix_limit, fix_base = small if small else (0, 0)
        if n < fix_limit:
            self.put("B", fix_base | n)
        elif codes[0] is not None and n <= 0xff:
            self.put("BB", codes[0], n)
        elif n <= 0xffff:
            self.put("BH", codes[1], n)
        else:
            self.put("BI", codes[2], n)

    def value(self, v) -> None:
        if isinstance(v, dict):
            # keys sorted, as Flax's trees (and JAX's tree_map) hold them
            self.sized(len(v), (16, 0x80), (None, 0xde, 0xdf))
            for k in sorted(v):
                if not isinstance(k, str):
                    raise TypeError(f"msgpack map key {k!r} is not a str")
                self.value(k)
                self.value(v[k])
        elif isinstance(v, (list, tuple)):
            self.sized(len(v), (16, 0x90), (None, 0xdc, 0xdd))
            for x in v:
                self.value(x)
        elif isinstance(v, str):
            b = v.encode("utf-8")
            self.sized(len(b), (32, 0xa0), (0xd9, 0xda, 0xdb))
            self.out += b
        elif isinstance(v, (bytes, bytearray)):
            self.sized(len(v), None, (0xc4, 0xc5, 0xc6))
            self.out += v
        elif isinstance(v, bool) or v is None:
            self.put("B", {None: 0xc0, False: 0xc2, True: 0xc3}[v])
        elif isinstance(v, int):
            self.int(v)
        elif isinstance(v, np.ndarray):
            self.ndarray(v)
        else:
            raise TypeError(f"msgpack cannot write {type(v).__name__}")

    def int(self, v: int) -> None:
        if 0 <= v < 0x80 or -0x20 <= v < 0:
            self.put("b" if v < 0 else "B", v)
            return
        for lo, hi, fmt, code in ((0, 0xff, "B", 0xcc),
                                  (-0x80, -1, "b", 0xd0),
                                  (0, 0xffff, "H", 0xcd),
                                  (-0x8000, -1, "h", 0xd1),
                                  (0, 0xffffffff, "I", 0xce),
                                  (-0x80000000, -1, "i", 0xd2),
                                  (0, 2 ** 64 - 1, "Q", 0xcf),
                                  (-2 ** 63, -1, "q", 0xd3)):
            if lo <= v <= hi:
                self.put("B" + fmt, code, v)
                return
        raise OverflowError(f"msgpack int out of range: {v}")

    def ndarray(self, a: np.ndarray) -> None:
        if a.dtype.hasobject or a.nbytes > _MSGPACK_CHUNK_LIMIT:
            raise ValueError("object arrays and arrays over 1 GiB are not "
                             "written")
        inner = _Writer()
        inner.value((tuple(int(d) for d in a.shape), a.dtype.name,
                     a.tobytes("C")))
        data = bytes(inner.out)
        n = len(data)
        fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
        if n in fixed:
            self.put("B", fixed[n])
        else:
            self.sized(n, None, (0xc7, 0xc8, 0xc9))
        self.put("b", _EXT_NDARRAY)
        self.out += data


def write_flax_msgpack(tree: dict) -> bytes:
    """The bytes that ``flax.serialization.msgpack_serialize`` writes for a
    tree of dicts with numpy array leaves (and ``to_bytes`` for a Flax
    parameter tree, whose keys are sorted)."""
    w = _Writer()
    w.value(tree)
    return bytes(w.out)


# --------------------------------------------------------------------------- #
# Flax parameter tree -> the port's state_dict
# --------------------------------------------------------------------------- #

_GATES = ("i", "f", "g", "o")
_RENAME = (
    (r"NodeEncoder_0", "node_encoder"),
    (r"EdgeEncoder_0", "edge_encoder"),
    (r"GlobalEncoder_0", "global_encoder"),
    (r"MLPBlock_0", "mlp"),
    (r"AttentionPooling_0", "attn_pool"),
    (r"GATv2Conv_(\d+)", r"convs.\1"),
    (r"Dense_(\d+)", r"dense_\1"),
    (r"layers_(\d+)", r"\1"),
    (r"lstm_(\d+)", r"cells.\1"),
)


def _rename(key: str, siblings) -> str:
    m = re.fullmatch(r"LayerNorm_(\d+)", key)
    if m:
        # the encoder's per-layer norms sit beside its GATv2 layers; an
        # MLPBlock has one
        return f"norms.{m.group(1)}" if "GATv2Conv_0" in siblings else "norm"
    for pat, rep in _RENAME:
        if re.fullmatch(pat, key):
            return re.sub(pat, rep, key)
    return key


def _leaf(name: str, arr) -> Tuple[str, torch.Tensor]:
    t = torch.from_numpy(np.array(arr, dtype=np.float32))
    if name == "kernel":
        return "weight", t.T.contiguous()
    if name == "scale":
        return "weight", t
    return name, t


def _convert(tree: dict, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    if {f"i{g}" for g in _GATES} <= set(tree):
        # a Flax LSTMCell: input kernels ii..io without bias, hidden
        # kernels hi..ho with bias, stacked in the gate order i, f, g, o
        def stack(kind, leaf):
            return np.concatenate(
                [np.asarray(tree[f"{kind}{g}"][leaf], np.float32).T
                 if leaf == "kernel"
                 else np.asarray(tree[f"{kind}{g}"][leaf], np.float32)
                 for g in _GATES])

        out[prefix + "ih.weight"] = torch.from_numpy(stack("i", "kernel"))
        out[prefix + "hh.weight"] = torch.from_numpy(stack("h", "kernel"))
        out[prefix + "hh.bias"] = torch.from_numpy(stack("h", "bias"))
        return
    for key, val in tree.items():
        if isinstance(val, dict):
            _convert(val, prefix + _rename(key, tree) + ".", out)
        else:
            name, t = _leaf(key, val)
            out[prefix + name] = t


def params_from_flax(tree: dict) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` (float32, on the CPU) from a Flax parameter
    tree of numpy arrays: :func:`read_flax_msgpack`'s result or the JAX
    package's ``jax.tree.map(np.asarray, params)``, with or without the
    top-level ``"params"``.  It serves the whole predictor and each of its
    modules alike."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}
    _convert(tree, "", out)
    return out


def _flax_path(key: str):
    """The Flax path of a port ``state_dict`` key, with the leaf's name and
    whether it is a kernel (transposed) -> (path, leaf, transpose)."""
    parts = key.split(".")
    tokens = []
    for part in parts:
        if part.isdigit():
            tokens[-1] += "." + part
        else:
            tokens.append(part)
    names = {"node_encoder": "NodeEncoder_0", "edge_encoder": "EdgeEncoder_0",
             "global_encoder": "GlobalEncoder_0", "mlp": "MLPBlock_0",
             "attn_pool": "AttentionPooling_0", "norm": "LayerNorm_0"}
    path = []
    for tok in tokens[:-1]:
        base, _, idx = tok.partition(".")
        if tok in names:
            path.append(names[tok])
        elif re.fullmatch(r"dense_\d+", tok):
            path.append("Dense_" + tok[len("dense_"):])
        elif base == "convs":
            path.append(f"GATv2Conv_{idx}")
        elif base == "norms":
            path.append(f"LayerNorm_{idx}")
        elif base == "cells":
            path.append(f"lstm_{idx}")
        elif base == "embed_rank":
            path += ["embed_rank", f"layers_{idx}"]
        else:
            path.append(tok)
    leaf = tokens[-1]
    if leaf != "weight":
        return path, leaf, False
    is_norm = tokens[-2] == "norm" or tokens[-2].startswith("norms.")
    return path, ("scale" if is_norm else "kernel"), not is_norm


def _sorted_tree(tree):
    return {k: _sorted_tree(v) if isinstance(v, dict) else v
            for k, v in sorted(tree.items())}


def params_to_flax(state_dict: Dict[str, torch.Tensor]) -> dict:
    """The Flax parameter tree (without the top-level ``"params"``, keys in
    Flax's sorted order, float32 numpy leaves) of a port ``state_dict``: the
    exact inverse of :func:`params_from_flax`, the LSTM cells' stacked
    products split back into Flax's eight gate kernels."""
    tree: dict = {}

    def put(path, leaf, arr):
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = arr

    for key, t in state_dict.items():
        a = t.detach().cpu().numpy().astype(np.float32)
        path, leaf, transpose = _flax_path(key)
        if path and path[-1] in ("ih", "hh"):
            kind, cell = path[-1][0], path[:-1]
            for g, rows in zip(_GATES, np.split(a, 4, axis=0)):
                put(cell + [kind + g], leaf,
                    np.ascontiguousarray(rows.T) if transpose else rows.copy())
        else:
            put(path, leaf, np.ascontiguousarray(a.T) if transpose else a)
    return _sorted_tree(tree)


def save_checkpoint(path_dir: str, model: RankSchedulePredictor,
                    cfg: ModelConfig, extra: Optional[dict] = None) -> None:
    """Write ``model.msgpack`` (the bytes Flax's ``to_bytes`` writes for the
    same parameters) and ``config.json`` into ``path_dir``."""
    os.makedirs(path_dir, exist_ok=True)
    with open(os.path.join(path_dir, "model.msgpack"), "wb") as f:
        f.write(write_flax_msgpack(
            {"params": params_to_flax(model.state_dict())}))
    payload = {"model_config": cfg.to_dict()}
    if extra:
        payload.update(extra)
    with open(os.path.join(path_dir, "config.json"), "w") as f:
        json.dump(payload, f, indent=2)


def load_model(ckpt: str, device=None
               ) -> Tuple[RankSchedulePredictor, ModelConfig]:
    """ckpt: directory containing model.msgpack (+config.json), or the
    msgpack file itself.  The model is returned in eval mode on ``device``
    (default: the first GPU; raises without one unless ``device="cpu"``)."""
    dev = resolve_device(device)
    if os.path.isdir(ckpt):
        msgpack_path = os.path.join(ckpt, "model.msgpack")
        cfg_path = os.path.join(ckpt, "config.json")
    else:
        msgpack_path = ckpt
        cfg_path = os.path.join(os.path.dirname(ckpt), "config.json")

    cfg = ModelConfig()
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            payload = json.load(f)
        cfg = ModelConfig.from_dict(payload.get("model_config", payload))

    model = RankSchedulePredictor(cfg)
    model.load_state_dict(params_from_flax(read_flax_msgpack(msgpack_path)),
                          strict=True)
    return model.to(dev).eval(), cfg


def graph_tensors(graph: dict, device) -> tuple:
    """The arguments of :meth:`RankSchedulePredictor.predict` for one graph
    dict (processor output) on ``device``."""
    x = torch.as_tensor(np.asarray(graph["x"], np.float32), device=device)
    return (x,
            torch.as_tensor(np.asarray(graph["edge_index"], np.int64),
                            device=device),
            torch.as_tensor(np.asarray(graph["edge_attr"], np.float32),
                            device=device),
            torch.zeros(x.shape[0], dtype=torch.long, device=device),
            torch.as_tensor(np.asarray(graph["global_attr"], np.float32),
                            device=device).reshape(1, -1),
            1)


def predict_raw(model: RankSchedulePredictor, graph: dict
                ) -> Tuple[np.ndarray, int]:
    """The unrounded schedule (max_seq_len,) and the predicted length for
    one graph dict, on the model's device."""
    dev = next(model.parameters()).device
    sched, lengths = model.predict(*graph_tensors(graph, dev))
    return sched[0].cpu().numpy(), int(lengths[0])


def predict_schedule_for_graph(model: RankSchedulePredictor, graph: dict,
                               min_rank: int = 1):
    """Run the predictor on one graph dict (processor output).

    Returns (schedule list[int], length int).
    """
    sched, L = predict_raw(model, graph)
    return schedule_from_raw(sched, L, min_rank), L


def schedule_from_raw(sched: np.ndarray, length: int,
                      min_rank: int = 1) -> list:
    """The integer schedule of an unrounded prediction: its first
    ``length`` values rounded, at least ``min_rank``."""
    return np.maximum(np.round(sched[:length]), min_rank).astype(int).tolist()
