"""Sharding-agnostic checkpoints under single-device names (PyTorch port of
``checkpoint/saver.py``), in the JAX package's on-disk format, so that a
checkpoint crosses between the two packages both ways.

The format: ``<dir>/ckpt-<step>/metadata.json`` (``format_version`` 2,
``step``, and ``entries``: each entry's logical ``shape``, ``dtype`` and,
for a leaf written in blocks, a ``shards`` list of ``start``/``stop``/
``file`` in logical coordinates) beside one ``<name>.npy`` per whole leaf
or one ``<name>.shard<j>.npy`` per block, in nested directories named by
the leaf's path (``params/layers_0/attn/wq/kernel``). Names are the JAX
pytree paths (``model_item._path_to_name``): a nested dict's keys, a
sequence's indices. bfloat16 leaves are written as JAX writes them (an
``.npy`` of descr ``'<V2'``, ``"bfloat16"`` in the metadata) and read back
through a 16-bit view, so no ``ml_dtypes`` is needed.

The ranks of a ``torch.distributed`` group render the JAX package's
per-process block writes: a leaf that is split over ranks is a
:class:`ShardedLeaf` (its logical shape, the block layout, identical on
every rank, and this rank's blocks), and each rank writes only its own
blocks; rank 0 writes the whole leaves and the metadata. Nothing is
gathered to save. Restore reads, from memory-mapped files, only the
regions each target leaf needs: a :class:`ShardedLeaf` target reads this
rank's blocks, whatever the layout the checkpoint was written in.

A write is atomic: it is staged in ``<path>.tmp-<pid>`` (``<path>.tmp``
across ranks), then swapped in through ``<path>.old-<pid>``; stale stage
directories of killed writers are swept, and ``max_to_keep`` old
checkpoints are dropped. Across ranks the stage -> files-written ->
swapped barriers run on the group's c10d store (``add``, pure RPC), never
as a collective: the JAX package's coordination-service barrier. A
collective on the asynchronous writer's thread would race the training
step's collectives.
"""
from __future__ import annotations

import glob
import hashlib
import json
import os
import re
import shutil
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch import const
from autodist_tpu_torch.utils import logging

_FORMAT_VERSION = 2
_BF16 = "bfloat16"


# ------------------------------------------------------------------ leaves
@dataclass
class ShardedLeaf:
    """One logical leaf split over ranks: ``shape`` and ``dtype`` of the
    whole, ``blocks`` the ``(start, stop)`` of every block in logical
    coordinates (the same list on every rank), and ``local`` this rank's
    blocks by their index in ``blocks``. As a restore target, ``local``'s
    tensors give the device and dtype to load each block into."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    blocks: List[Tuple[Tuple[int, ...], Tuple[int, ...]]]
    local: Dict[int, torch.Tensor] = field(default_factory=dict)


def dtype_name(dtype) -> str:
    """The metadata's dtype string (numpy's names) of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(np.dtype(dtype))


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, "bool" if name == "bool" else name)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_names(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(name, leaf)`` of every leaf, named by its path as JAX names it: a
    dict's keys (sorted), a sequence's indices, a named tuple's fields.
    Empty containers hold no leaves."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(tree, dict):
        out = []
        for k in sorted(tree, key=str):
            out += flatten_with_names(tree[k], join(k))
        return out
    if _is_namedtuple(tree):
        out = []
        for f in tree._fields:
            out += flatten_with_names(getattr(tree, f), join(f))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten_with_names(v, join(i))
        return out
    return [(prefix, tree)]


def map_with_names(fn, tree, prefix: str = ""):
    """``tree`` with every leaf replaced by ``fn(name, leaf)``."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(tree, dict):
        return {k: map_with_names(fn, v, join(k)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_names(fn, getattr(tree, f), join(f))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_names(fn, v, join(i)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def _shape_dtype(leaf) -> Tuple[Tuple[int, ...], str]:
    if isinstance(leaf, ShardedLeaf):
        return tuple(leaf.shape), dtype_name(leaf.dtype)
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), dtype_name(leaf.dtype)
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return (), "int32"              # steps and counts: JAX's int32 scalars
    arr = np.asarray(leaf)
    return tuple(arr.shape), dtype_name(arr.dtype)


def _to_numpy(value, dtype: str) -> np.ndarray:
    """A host copy of one leaf or block as the numpy array to write (a
    bfloat16 tensor as its 16-bit pattern)."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16)
        return t.cpu().numpy()
    return np.asarray(value, dtype=np.dtype(dtype))


def _save_npy(fpath: str, arr: np.ndarray, dtype: str) -> None:
    """``np.save``, but a bfloat16 pattern gets JAX's header (descr
    ``'<V2'``), so the file is the one the JAX package writes."""
    if dtype != _BF16:
        np.save(fpath, arr)
        return
    arr = np.array(arr, order="C")
    with open(fpath, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": tuple(arr.shape)})
        f.write(arr.tobytes())


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A region read from a file as a CPU tensor of the entry's dtype."""
    arr = np.array(arr, order="C")            # a copy: no view of the mmap
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


# ------------------------------------------------------------------- group
def _group_info(group) -> Tuple[int, int]:
    if group is None or not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


class _StoreBarrier:
    """A barrier on the default group's c10d store: each rank adds one to
    a key named for the save, the path and the tag, then polls the count
    until every rank has arrived (``add`` of 0 reads it). Pure RPC to the
    store's server, never a collective, so it is safe on the writer
    thread; a rank that does not arrive within the timeout fails the
    save."""

    def __init__(self, world: int, timeout_ms: int):
        from torch.distributed import distributed_c10d

        self.store = distributed_c10d._get_default_store()
        self.world = world
        self.timeout_s = timeout_ms / 1e3

    def __call__(self, key: str) -> None:
        self.store.add(key, 1)
        deadline = time.monotonic() + self.timeout_s
        while self.store.add(key, 0) < self.world:
            if time.monotonic() > deadline:
                raise TimeoutError(f"checkpoint barrier {key!r}: not every rank arrived")
            time.sleep(0.005)


# ------------------------------------------------------------------- saver
class Saver:
    """Save and restore state trees across shardings and across the two
    packages. Like the JAX Saver it is decoupled from the train step: it
    takes any tree of tensors, numpy arrays, Python ints and
    :class:`ShardedLeaf` blocks, and deals only in names and logical
    values. ``group`` is the process group whose ranks save together (the
    default group when one is formed)."""

    def __init__(self, directory: Optional[str] = None, max_to_keep: int = 0, group=None):
        self.directory = directory or const.DEFAULT_CHECKPOINT_DIR
        self.max_to_keep = max_to_keep
        if group is None and dist.is_initialized():
            group = dist.group.WORLD
        self.group = group
        self._pending: Optional[threading.Thread] = None
        self._pending_error: Optional[BaseException] = None
        self._save_seq = 0          # barrier-key uniqueness across saves

    def _list_checkpoints(self) -> List[str]:
        """``ckpt-<step>`` entries under ``directory``, step-ascending."""
        if not os.path.isdir(self.directory):
            return []
        return sorted((d for d in os.listdir(self.directory) if re.fullmatch(r"ckpt-\d+", d)),
                      key=lambda d: int(d.split("-")[1]))

    # ------------------------------------------------------------------ save
    def _collect(self, tree) -> Tuple[Dict[str, dict], List[Tuple[str, Any, str]]]:
        """(metadata entries of every leaf, the files this rank writes as
        ``(file, value, dtype)``): a :class:`ShardedLeaf`'s own blocks, and
        on rank 0 the whole leaves. A layout of one block is a whole leaf
        written by the rank that holds it."""
        rank, _ = _group_info(self.group)
        entries: Dict[str, dict] = {}
        files: List[Tuple[str, Any, str]] = []
        for name, leaf in flatten_with_names(tree):
            if name in entries:
                raise ValueError(f"flat name collision at {name!r}: two distinct leaves "
                                 f"map to one checkpoint entry")
            shape, dtype = _shape_dtype(leaf)
            entry: Dict[str, Any] = {"shape": list(shape), "dtype": dtype}
            if isinstance(leaf, ShardedLeaf) and len(leaf.blocks) > 1:
                entry["shards"] = []
                for j, (start, stop) in enumerate(leaf.blocks):
                    fname = f"{name}.shard{j}.npy"
                    entry["shards"].append({"start": list(start), "stop": list(stop),
                                            "file": fname})
                    if j in leaf.local:
                        files.append((fname, leaf.local[j], dtype))
            elif isinstance(leaf, ShardedLeaf):
                if 0 in leaf.local:
                    files.append((name + ".npy", leaf.local[0], dtype))
            elif rank == 0:
                files.append((name + ".npy", leaf, dtype))
            entries[name] = entry
        return entries, files

    def save(self, tree: Any, path: Optional[str] = None, step: Optional[int] = None,
             block: bool = True) -> str:
        """Write ``tree`` to ``path`` (default ``<directory>/ckpt-<step>``;
        a step-less save lands in ``ckpt-0``). Every rank of the group calls
        it, in the same order; each writes its own blocks, rank 0 the whole
        leaves and the metadata, and all return the same path after the
        last barrier.

        ``block=False`` copies every value this rank writes to the host on
        the calling thread (so the next step may change the tensors) and
        writes the files on a background thread; :meth:`wait` (or any
        restore or ``latest_checkpoint``) joins it and re-raises its
        failure."""
        self.wait()
        if path is None:
            path = os.path.join(self.directory, f"ckpt-{step or 0}")
        entries, files = self._collect(tree)
        self._save_seq += 1
        if not block:
            # A copy: a CPU tensor's numpy view would follow the training.
            files = [(f, np.array(_to_numpy(v, d)), d) for f, v, d in files]
            # Non-daemon: a normal interpreter exit waits for the write.
            self._pending = threading.Thread(
                target=self._write_guarded, args=(path, step, entries, files, self._save_seq))
            self._pending.start()
            return path
        self._write(path, step, entries, files, self._save_seq)
        return path

    def _write(self, path: str, step: Optional[int], entries: Dict[str, dict],
               files: Sequence[Tuple[str, Any, str]], seq: int) -> None:
        """Stage into a tmp dir and swap it in, so a killed writer never
        leaves a metadata-less ``ckpt`` dir; across ranks all stage into one
        dir, with a store barrier between the steps."""
        rank, world = _group_info(self.group)
        multi = world > 1
        tmp = path + (".tmp" if multi else f".tmp-{os.getpid()}")
        barrier = (_StoreBarrier(world, const.ASYNC_SAVE_BARRIER_TIMEOUT_MS)
                   if multi else None)
        digest = hashlib.sha1(os.path.abspath(path).encode()).hexdigest()[:12]

        def sync(tag: str) -> None:
            if barrier is not None:
                barrier(f"autodist_torch/save/{digest}/{seq}/{tag}")

        if rank == 0:
            # Leftovers of killed writers: checkpoint-sized garbage that
            # _list_checkpoints ignores.
            for stale in glob.glob(path + ".tmp*") + glob.glob(path + ".old-*"):
                if stale != tmp:
                    shutil.rmtree(stale, ignore_errors=True)
            os.makedirs(tmp, exist_ok=True)
        sync("staged-dir")
        for fname, value, dtype in files:
            fpath = os.path.join(tmp, fname)
            os.makedirs(os.path.dirname(fpath), exist_ok=True)
            _save_npy(fpath, _to_numpy(value, dtype), dtype)
        sync("files-written")
        if rank == 0:
            meta = {"format_version": _FORMAT_VERSION, "step": step, "entries": entries}
            with open(os.path.join(tmp, "metadata.json"), "w", encoding="utf-8") as f:
                json.dump(meta, f, indent=2, sort_keys=True)
            old = path + f".old-{os.getpid()}"
            if os.path.exists(path):
                os.rename(path, old)
            os.rename(tmp, path)
            shutil.rmtree(old, ignore_errors=True)
            self._gc()
        sync("swapped")
        logging.info("saved checkpoint with %d arrays -> %s", len(entries), path)

    def _write_guarded(self, path, step, entries, files, seq) -> None:
        try:
            self._write(path, step, entries, files, seq)
        except BaseException as e:  # noqa: BLE001 - re-raised from wait()
            self._pending_error = e

    def wait(self) -> None:
        """Block until an in-flight asynchronous save has written; re-raise
        its failure here rather than let a torn save pass silently."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        err, self._pending_error = self._pending_error, None
        if err is not None:
            raise RuntimeError("async checkpoint save failed") from err

    def _gc(self) -> None:
        if self.max_to_keep <= 0:
            return
        for stale in self._list_checkpoints()[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, stale), ignore_errors=True)

    # --------------------------------------------------------------- restore
    @staticmethod
    def _read_region(path: str, name: str, entry: dict, start: Sequence[int],
                     stop: Sequence[int]) -> np.ndarray:
        """The logical region ``[start, stop)`` of an entry, from only the
        files that overlap it (memory-mapped, partial reads)."""
        req_shape = tuple(b - a for a, b in zip(start, stop))
        shards = entry.get("shards")
        if shards is None:
            data = np.load(os.path.join(path, name + ".npy"), mmap_mode="r")
            return np.asarray(data[tuple(slice(a, b) for a, b in zip(start, stop))])
        out: Optional[np.ndarray] = None
        covered = 0
        volume = int(np.prod(req_shape)) if req_shape else 1
        for sh in shards:
            s_start, s_stop = sh["start"], sh["stop"]
            lo = [max(a, sa) for a, sa in zip(start, s_start)]
            hi = [min(b, sb) for b, sb in zip(stop, s_stop)]
            if any(a >= b for a, b in zip(lo, hi)):
                continue
            data = np.load(os.path.join(path, sh["file"]), mmap_mode="r")
            src = tuple(slice(a - sa, b - sa) for a, b, sa in zip(lo, hi, s_start))
            if tuple(lo) == tuple(start) and tuple(hi) == tuple(stop):
                return np.asarray(data[src])
            if out is None:
                out = np.empty(req_shape, dtype=data.dtype)
            dst = tuple(slice(a - ra, b - ra) for a, b, ra in zip(lo, hi, start))
            out[dst] = data[src]
            covered += int(np.prod([b - a for a, b in zip(lo, hi)]))
        # The blocks tile the entry disjointly, so the overlaps must sum to
        # the region: a shortfall is a missing or mislisted block.
        if out is None or covered != volume:
            raise ValueError(
                f"checkpoint entry {name!r}: shards cover {covered} of {volume} "
                f"elements in region {list(start)}:{list(stop)} — corrupt or "
                f"incomplete block layout")
        return out

    def _load(self, path, name, entry, start, stop, dtype=None, device="cpu"):
        t = _to_tensor(self._read_region(path, name, entry, start, stop), entry["dtype"])
        if dtype is not None and t.dtype != dtype:
            t = t.to(dtype)
        return t.to(device)

    def restore(self, path: str, target: Any = None, device=None) -> Any:
        """Load a checkpoint (after any in-flight save).

        Without ``target``, the nested dict of the stored names, as CPU
        tensors. With ``target`` (a tree of tensors, Python ints or
        :class:`ShardedLeaf` templates), leaves are matched by
        name: extra entries are ignored, a missing one raises ``KeyError``,
        a shape that differs raises ``ValueError``; each leaf is cast to
        the target's dtype and placed on the target tensor's device
        (``device`` overrides; a meta tensor loads to the CPU). An int
        target comes back an int, a :class:`ShardedLeaf` with this rank's
        blocks read."""
        self.wait()
        entries = self.read_metadata(path)["entries"]
        if target is None:
            out: Dict[str, Any] = {}
            for name, entry in entries.items():
                node = out
                parts = name.split("/")
                for part in parts[:-1]:
                    node = node.setdefault(part, {})
                shape = tuple(entry["shape"])
                node[parts[-1]] = self._load(path, name, entry, (0,) * len(shape), shape,
                                             device=device or "cpu")
            return out

        def leaf(name, want):
            if name not in entries:
                raise KeyError(f"checkpoint {path} has no entry {name!r} "
                               f"(has: {sorted(entries)[:8]}...)")
            entry = entries[name]
            shape = tuple(entry["shape"])
            want_shape, want_dtype = _shape_dtype(want)
            if shape != want_shape:
                raise ValueError(
                    f"checkpoint entry {name!r} has shape {shape}, target wants "
                    f"{want_shape} — checkpoints store the logical (unpartitioned) "
                    f"tensor, so this is a real model mismatch, not a sharding "
                    f"difference. If this state came from a pad-and-mask plan, save "
                    f"it with step.save(saver, state) (or pass "
                    f"step.logical_state(state)) so padded storage shapes never reach "
                    f"the checkpoint.")
            if isinstance(want, ShardedLeaf):
                local = {j: self._load(path, name, entry, *want.blocks[j], dtype=t.dtype,
                                       device=device or _home(t))
                         for j, t in want.local.items()}
                return ShardedLeaf(want.shape, want.dtype, want.blocks, local)
            t = self._load(path, name, entry, (0,) * len(shape), shape,
                           dtype=torch_dtype(want_dtype),
                           device=device or (_home(want) if isinstance(want, torch.Tensor)
                                             else "cpu"))
            return int(t.item()) if isinstance(want, int) else t

        return map_with_names(leaf, target)

    def restore_subtree(self, path: str, prefix: str, target: Any = None,
                        device=None) -> Any:
        """Only the entries under ``<prefix>/``, matched against
        ``target``'s unprefixed names (the serving loader's primitive: a
        training checkpoint's ``params/`` without its optimizer slots).
        ``prefix=""`` is :meth:`restore`."""
        if not prefix:
            return self.restore(path, target=target, device=device)
        return self.restore(path, target={prefix: target}, device=device)[prefix]

    # ------------------------------------------------------------- utilities
    @staticmethod
    def read_metadata(path: str) -> dict:
        with open(os.path.join(path, "metadata.json"), "r", encoding="utf-8") as f:
            return json.load(f)

    def latest_checkpoint(self) -> Optional[str]:
        """The newest ``ckpt-<step>`` under ``directory``, or None (after any
        in-flight save)."""
        self.wait()
        ckpts = self._list_checkpoints()
        return os.path.join(self.directory, ckpts[-1]) if ckpts else None

    def restore_latest(self, target: Any = None, device=None) -> Optional[Any]:
        """The newest checkpoint, or None when there is none: the resume
        primitive, ``saver.restore_latest(target) or fresh``."""
        path = self.latest_checkpoint()
        if path is None:
            return None
        logging.info("resuming from %s", path)
        return self.restore(path, target=target, device=device)


def _home(t: torch.Tensor):
    """Where a leaf restored against ``t`` goes: its device, the CPU for a
    meta tensor."""
    return "cpu" if t.device.type == "meta" else t.device


__all__ = ["Saver", "ShardedLeaf", "flatten_with_names", "map_with_names", "dtype_name",
           "torch_dtype"]
