"""Checkpoint files in the reference's format, and their managers.

Counterpart of tal_asrd_tpu/core/checkpoint.py: the reference writes
parameter trees as flax msgpack bytes. This is a minimal pure-Python reader
and writer of the msgpack subset that format uses — maps, strings,
binaries, integers, floats, booleans, arrays and extension types — so the
port needs neither `msgpack` nor `flax`. Extension type 1 is an ndarray
packed as msgpack `(shape, dtype_name, bytes)`; type 3 is a numpy scalar in
the same packing; the reader re-joins leaves that arrive as chunk
dictionaries (arrays over 2**30 bytes); the writer refuses such leaves. The
writer emits the bytes flax's `msgpack_serialize` emits for the same tree,
so the reference's `load_pytree` reads the port's files.

numpy has no bfloat16, so a `bfloat16` leaf comes back as its 16-bit
patterns in an array of dtype `BFLOAT16_BITS` (uint16 tagged through dtype
metadata), and such an array is written as `bfloat16`. `core/convert.py`
turns them into `torch.bfloat16` and back with a view; `is_bfloat16_bits`
tells them apart from ordinary uint16 data.

The partial loads of the training CLI work on those trees (flax names and
layouts): `load_params_partial` (strict or not, speaker-embedding growth by
`expand_speaker_embeddings`, the enc_posenc gate kept at zero when the
checkpoint lacks it), `filter_subtree` and `merge_subtree`.

`CheckpointManager` keeps every saved parameter tree (`ckpt_<step>.msgpack`,
`latest.json`) and full training states (`state_<step>.msgpack`), and
averages the last k parameter trees (`average_params`).

`ShardedCheckpointManager` writes a sharded training state (a nested dict
of tensors and DTensors, `ASRSystem.sharded_state`) with
torch.distributed.checkpoint (DCP): every process writes the shards it
owns, asynchronously by default, into `state_<step>` directories, and
restores into a template whose leaves keep their placements. The JAX
package's manager writes orbax's format instead, which needs orbax and
tensorstore to read; the two packages exchange the msgpack files.
"""
from __future__ import annotations

import json
import os
import re
import struct
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

# uint16 carrying bfloat16 bit patterns. The metadata survives frombuffer /
# reshape / view, which is all the loader does with it.
BFLOAT16_BITS = np.dtype(np.uint16, metadata={"bits_of": "bfloat16"})

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


def is_bfloat16_bits(arr: np.ndarray) -> bool:
    """True for arrays that hold bfloat16 bit patterns: this loader's tagged
    uint16, or a third-party 2-byte dtype named 'bfloat16'."""
    meta = arr.dtype.metadata
    if meta is not None and meta.get("bits_of") == "bfloat16":
        return True
    return arr.dtype.name == "bfloat16"


def to_tensor(arr: Any) -> torch.Tensor:
    """numpy leaf -> torch tensor (a copy), bfloat16 bit patterns included."""
    arr = np.asarray(arr)
    if is_bfloat16_bits(arr):
        bits = np.array(arr, copy=True).view(np.int16).reshape(arr.shape)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch tensor -> numpy leaf (a copy, on the host); bfloat16 becomes
    its bit patterns tagged as such."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BFLOAT16_BITS).copy()
    return t.numpy().copy()


def tree_leaves(tree: dict, prefix: Tuple[str, ...] = ()):
    """(key path, leaf) of each leaf of a nested dict, in its order."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from tree_leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def tree_from_leaves(items) -> dict:
    """The nested dict of (key path, leaf) pairs; `tree_leaves`' inverse."""
    out: dict = {}
    for path, value in items:
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value
    return out


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def num(self, fmt: str):
        (v,) = struct.unpack(fmt, self.take(struct.calcsize(fmt)))
        return v

    def read(self) -> Any:
        t = self.num("B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self.string(t & 0x1F)
        if t == 0xC0:
            return None
        if t == 0xC2:
            return False
        if t == 0xC3:
            return True
        if t in (0xC4, 0xC5, 0xC6):
            n = self.num((">B", ">H", ">I")[t - 0xC4])
            return bytes(self.take(n))
        if t in (0xC7, 0xC8, 0xC9):
            n = self.num((">B", ">H", ">I")[t - 0xC7])
            return self.ext(n)
        if t == 0xCA:
            return self.num(">f")
        if t == 0xCB:
            return self.num(">d")
        if 0xCC <= t <= 0xCF:
            return self.num((">B", ">H", ">I", ">Q")[t - 0xCC])
        if 0xD0 <= t <= 0xD3:
            return self.num((">b", ">h", ">i", ">q")[t - 0xD0])
        if 0xD4 <= t <= 0xD8:
            return self.ext(1 << (t - 0xD4))
        if t in (0xD9, 0xDA, 0xDB):
            return self.string(self.num((">B", ">H", ">I")[t - 0xD9]))
        if t in (0xDC, 0xDD):
            return self.array(self.num((">H", ">I")[t - 0xDC]))
        if t in (0xDE, 0xDF):
            return self.map(self.num((">H", ">I")[t - 0xDE]))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def string(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def ext(self, n: int) -> Any:
        code = self.num("b")
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(payload)[()]
        raise ValueError(f"unsupported msgpack extension type {code}")


def _ndarray_from_bytes(payload: bytes) -> np.ndarray:
    shape, dtype_name, raw = _Reader(payload).read()
    dtype = BFLOAT16_BITS if dtype_name == "bfloat16" else np.dtype(dtype_name)
    return np.frombuffer(raw, dtype=dtype).reshape(tuple(shape))


def _index_dict_to_tuple(d: dict) -> Tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(node: Any) -> Any:
    """Re-join leaves the writer split into chunks (arrays over 2**30 bytes)."""
    if not isinstance(node, dict):
        return node
    if _CHUNKED in node:
        shape = _index_dict_to_tuple(node["shape"])
        chunks = _index_dict_to_tuple(node["chunks"])
        # concatenate drops dtype metadata; the view puts the tag back
        return np.concatenate(chunks).view(chunks[0].dtype).reshape(shape)
    return {k: _unchunk(v) for k, v in node.items()}


def msgpack_restore(data: bytes) -> Any:
    """msgpack bytes -> nested dict of numpy arrays (and Python scalars)."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)


def load_pytree(path: str) -> Any:
    """Read a checkpoint file into a nested dict of numpy arrays."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------
_MAX_LEAF_BYTES = 2 ** 30


def _pack_len(out: List[bytes], n: int, small: Optional[int], codes) -> None:
    """Header of a sized type: fix form (small: its base byte and limit) or
    the 8/16/32-bit forms `codes`."""
    if small is not None and n < small[1]:
        out.append(bytes([small[0] | n]))
    elif codes[0] is not None and n < 1 << 8:
        out.append(struct.pack(">BB", codes[0], n))
    elif n < 1 << 16:
        out.append(struct.pack(">BH", codes[1], n))
    elif n < 1 << 32:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError(f"msgpack object of size {n} is too large")


def _pack_int(out: List[bytes], x: int) -> None:
    if 0 <= x < 0x80 or -0x20 <= x < 0:
        out.append(struct.pack(">b" if x < 0 else ">B", x))
    elif x >= 0:
        for code, fmt, limit in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16),
                                 (0xCE, ">BI", 1 << 32), (0xCF, ">BQ", 1 << 64)):
            if x < limit:
                out.append(struct.pack(fmt, code, x))
                return
        raise ValueError(f"integer {x} does not fit msgpack")
    else:
        for code, fmt, limit in ((0xD0, ">Bb", 1 << 7), (0xD1, ">Bh", 1 << 15),
                                 (0xD2, ">Bi", 1 << 31), (0xD3, ">Bq", 1 << 63)):
            if x >= -limit:
                out.append(struct.pack(fmt, code, x))
                return
        raise ValueError(f"integer {x} does not fit msgpack")


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    name = "bfloat16" if is_bfloat16_bits(arr) else arr.dtype.name
    if arr.dtype.hasobject:
        raise TypeError("object arrays cannot be written")
    raw = np.ascontiguousarray(arr).tobytes()
    if len(raw) > _MAX_LEAF_BYTES:
        raise ValueError(f"an array leaf of {len(raw)} bytes exceeds the "
                         f"{_MAX_LEAF_BYTES}-byte limit of one leaf")
    return msgpack_serialize((tuple(int(d) for d in arr.shape), name, raw))


def _pack_ext(out: List[bytes], code: int, payload: bytes) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(struct.pack(">Bb", fixed[n], code))
    else:
        _pack_len(out, n, None, (0xC7, 0xC8, 0xC9))
        out.append(struct.pack(">b", code))
    out.append(payload)


def _pack(out: List[bytes], obj: Any) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        _pack_int(out, obj)
    elif type(obj) is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif type(obj) is str:
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out.append(raw)
    elif type(obj) is bytes:
        _pack_len(out, len(obj), None, (0xC4, 0xC5, 0xC6))
        out.append(obj)
    elif type(obj) in (list, tuple):
        _pack_len(out, len(obj), (0x90, 16), (None, 0xDC, 0xDD))
        for item in obj:
            _pack(out, item)
    elif type(obj) is dict:
        _pack_len(out, len(obj), (0x80, 16), (None, 0xDE, 0xDF))
        for key in sorted(obj):          # flax writes a tree's keys sorted
            _pack(out, key)
            _pack(out, obj[key])
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    else:
        raise TypeError(f"cannot write a {type(obj).__name__} to msgpack")


def msgpack_serialize(tree: Any) -> bytes:
    """Nested dict / list / tuple of numpy arrays, numpy scalars and Python
    scalars -> msgpack bytes, as flax's `msgpack_serialize` writes them."""
    out: List[bytes] = []
    _pack(out, tree)
    return b"".join(out)


def save_pytree(path: str, tree: Any) -> None:
    """Atomic write (a temporary file, then a rename), so a writer killed
    mid-save never leaves a truncated file at `path`."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    data = msgpack_serialize(tree)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# Partial loads
# ---------------------------------------------------------------------------
class LeafSpec:
    """Shape and numpy dtype of a parameter leaf, without its values: the
    target of a partial load names what it expects without a fetch of the
    model's parameters from the device."""

    def __init__(self, shape, dtype):
        self.shape = tuple(int(d) for d in shape)
        self.dtype = dtype

    def __repr__(self) -> str:
        return f"LeafSpec({self.shape}, {self.dtype})"


def cast_leaf(value: Any, dtype) -> np.ndarray:
    """A numpy leaf in `dtype` (bfloat16 bit patterns included: widened
    exactly, rounded to nearest even), through torch."""
    empty = np.empty(0, dtype)
    target = torch.bfloat16 if is_bfloat16_bits(empty) else torch.from_numpy(empty).dtype
    return to_numpy(to_tensor(value).to(target))


def filter_subtree(params: dict, prefix: str) -> dict:
    """The subtree under `prefix` ('encoder', or 'a/b')."""
    node = params
    for part in prefix.split("/"):
        node = node[part]
    return node


def merge_subtree(params: dict, prefix: str, subtree: dict) -> dict:
    """`params` with the subtree at `prefix` replaced (the input is left as
    it was)."""
    def rec(node, parts):
        node = dict(node)
        node[parts[0]] = subtree if len(parts) == 1 else rec(node[parts[0]], parts[1:])
        return node

    return rec(params, prefix.split("/"))


def expand_speaker_embeddings(embedding: np.ndarray, new_num_tokens: int,
                              seed: int = 0) -> np.ndarray:
    """Grow an embedding table [V, d] to `new_num_tokens` rows for newly
    appended speaker tokens (or cut it to them). New rows are drawn
    uniform(-1/sqrt(d), 1/sqrt(d)) by `np.random.RandomState(seed)` in
    float64, as the reference draws them, then cast to the table's dtype."""
    embedding = np.asarray(embedding)
    old_n, d = embedding.shape
    if new_num_tokens <= old_n:
        return embedding[:new_num_tokens]
    bound = 1.0 / np.sqrt(d)
    rng = np.random.RandomState(seed)
    extra = rng.uniform(-bound, bound, size=(new_num_tokens - old_n, d))
    extra = cast_leaf(extra, embedding.dtype)
    return np.concatenate([embedding, extra], 0).view(embedding.dtype)


def load_params_partial(target_params: dict, ckpt_params: dict, strict: bool = True,
                        expand_embeddings_to: Optional[int] = None) -> dict:
    """`target_params` (a parameter tree whose leaves have .shape and .dtype:
    numpy arrays or `LeafSpec`s) with each leaf replaced by the
    checkpoint's, cast to the target leaf's dtype.

    strict=False keeps the target leaf where the checkpoint lacks it or has
    another shape (--no-strict); strict raises (KeyError, ValueError).
    `expand_embeddings_to` first grows `embedding/embedding` to that many
    rows. The enc_posenc gate `mem_pos_alpha` keeps the target's zero when
    the checkpoint lacks it, strict or not: the gated model then equals the
    checkpoint's."""
    flat_c = dict(tree_leaves(ckpt_params))
    out = []
    for path, tv in tree_leaves(target_params):
        cv = flat_c.get(path)
        if cv is not None and expand_embeddings_to and path[-2:] == ("embedding", "embedding"):
            cv = expand_speaker_embeddings(cv, expand_embeddings_to)
        if cv is None and path[-1] == "mem_pos_alpha":
            out.append((path, tv))
            continue
        if cv is None or tuple(np.shape(cv)) != tuple(tv.shape):
            name = "/".join(path)
            if strict and cv is None:
                raise KeyError(f"Missing checkpoint param {name}")
            if strict:
                raise ValueError(f"Shape mismatch at {name}: ckpt {np.shape(cv)} "
                                 f"vs target {tuple(tv.shape)}")
            out.append((path, tv))
        else:
            out.append((path, cast_leaf(cv, tv.dtype)))
    return tree_from_leaves(out)


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _mean_leaf(*leaves) -> np.ndarray:
    """Mean in float64, cast back to the leaves' dtype (bfloat16 bit
    patterns rounded to nearest even, through torch)."""
    ts = [to_tensor(x) for x in leaves]
    mean = sum(t.to(torch.float64) for t in ts) / len(ts)
    return to_numpy(mean.to(ts[0].dtype))


def average_params(param_trees: Sequence[Any]) -> Any:
    """Leaf-wise mean of k parameter trees of one structure."""
    if not param_trees:
        raise ValueError("no parameter trees to average")
    return _tree_map(_mean_leaf, *param_trees)


# ---------------------------------------------------------------------------
# Manager
# ---------------------------------------------------------------------------
class CheckpointManager:
    """Keep-all parameter checkpoints + a latest pointer + averaging, and
    full training-state checkpoints for an exact resume."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.msgpack")

    def _state_path(self, step: int) -> str:
        return os.path.join(self.dir, f"state_{step:08d}.msgpack")

    def _steps(self, pattern: str) -> List[int]:
        return sorted(int(m.group(1)) for m in
                      (re.match(pattern, f) for f in os.listdir(self.dir)) if m)

    def save(self, step: int, params: Any, extra: Optional[dict] = None) -> str:
        """Write a parameter tree and point `latest.json` at it."""
        path = self._path(step)
        save_pytree(path, params)
        manifest = {"step": step, "path": os.path.basename(path)}
        if extra:
            manifest.update(extra)
        tmp = os.path.join(self.dir, "latest.json.tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(self.dir, "latest.json"))
        return path

    def steps(self) -> List[int]:
        return self._steps(r"ckpt_(\d+)\.msgpack$")

    def load(self, step: Optional[int] = None) -> Any:
        """The parameter tree of `step` (the latest if None)."""
        if step is None:
            steps = self.steps()
            if not steps:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
            step = steps[-1]
        return load_pytree(self._path(step))

    def average_last(self, k: int) -> Any:
        steps = self.steps()[-k:]
        if not steps:
            raise FileNotFoundError(f"no checkpoints to average in {self.dir}")
        return average_params([self.load(s) for s in steps])

    def save_state(self, step: int, state_tree: Any) -> str:
        """Write a full training state (step, params, optimizer moments)."""
        path = self._state_path(step)
        save_pytree(path, state_tree)
        return path

    def state_steps(self) -> List[int]:
        return self._steps(r"state_(\d+)\.msgpack$")

    def load_state(self, step: Optional[int] = None) -> Any:
        """The training-state tree of `step` (the latest if None)."""
        if step is None:
            step = self.latest_state_step()
            if step is None:
                raise FileNotFoundError(f"no state checkpoints in {self.dir}")
        return load_pytree(self._state_path(step))

    def latest_state_step(self) -> Optional[int]:
        steps = self.state_steps()
        return steps[-1] if steps else None


class ShardedCheckpointManager:
    """Sharded, asynchronous training-state checkpoints on DCP, for a
    process group (every process calls every method).

      * `save_state` starts the write and returns once the state is staged
        (copied off the live tensors), so the write overlaps the next
        steps; a new save waits for the previous one first, and
        `wait_until_finished` waits for the last;
      * `load_state(template)` restores in place into a template tree of
        the same keys: each DTensor leaf gets its own shards, on the
        template's device and with its placements, so no process holds the
        full state.

    A `state_<step>` directory counts once its metadata file is written,
    the last act of a save.

    The staging is a copy on the leaves' own device (a DTensor's local
    shard, re-wrapped with its placements), and the writes coordinate over
    a gloo group of their own, made here (so every process constructs the
    manager): the background write's collectives then never interleave
    with the training's on the default group."""

    def __init__(self, directory: str, async_save: bool = True):
        import torch.distributed as dist
        self.dir = os.path.abspath(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.async_save = async_save
        self._pending = None
        self._group = (dist.new_group(backend="gloo") if dist.is_initialized() else None)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"state_{step:08d}")

    def save_state(self, step: int, state_tree: Any) -> str:
        import torch.distributed.checkpoint as dcp
        self.wait_until_finished()
        path = self._path(step)
        if self.async_save:
            self._pending = dcp.async_save(state_tree, checkpoint_id=path,
                                           process_group=self._group,
                                           async_stager=_DeviceCopyStager())
        else:
            dcp.save(state_tree, checkpoint_id=path, process_group=self._group)
        return path

    def wait_until_finished(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def state_steps(self) -> List[int]:
        out = []
        for f in os.listdir(self.dir):
            m = re.match(r"state_(\d+)$", f)
            if m and os.path.exists(os.path.join(self.dir, f, ".metadata")):
                out.append(int(m.group(1)))
        return sorted(out)

    def load_state(self, target: Any, step: Optional[int] = None) -> Any:
        """Restore into `target` in place and return it."""
        import torch.distributed.checkpoint as dcp
        self.wait_until_finished()
        steps = self.state_steps()
        if not steps:
            raise FileNotFoundError(f"No sharded checkpoints in {self.dir}")
        step = steps[-1] if step is None else step
        dcp.load(target, checkpoint_id=self._path(step), process_group=self._group)
        return target

    def latest_state_step(self) -> Optional[int]:
        steps = self.state_steps()
        return steps[-1] if steps else None

    def close(self) -> None:
        self.wait_until_finished()


def _stage_copy(tree: Any) -> Any:
    """A copy of a state tree on its leaves' devices, DTensors re-wrapped."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: _stage_copy(v) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        return DTensor.from_local(tree.to_local().clone(), tree.device_mesh, tree.placements,
                                  run_check=False, shape=tree.shape, stride=tree.stride())
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return tree


class _DeviceCopyStager:
    """dcp.async_save's stager (its AsyncStager protocol): `_stage_copy`,
    finished when `stage` returns."""

    should_synchronize_after_execute = False

    def stage(self, state_dict):
        return _stage_copy(state_dict)

    def synchronize_staging(self) -> None:
        pass

    def close(self) -> None:
        pass
