"""On-disk dataset format: sharded ``.npy`` files + a JSON manifest.

The port's copy of the JAX package's ``data/files.py``: the same directory
layout, so each package reads the other's datasets. Fixed-shape row shards
are opened with ``np.load(mmap_mode="r")``, so the native gather engine
(``csrc/dataloader.cc``) copies rows straight out of the page cache and a
dataset larger than RAM streams from disk with no decode step and no Python
on the hot path. Variable-size records (JPEG bytes, token streams) are
materialized to a fixed shape once, when the dataset is written
(:class:`DatasetWriter`): decode once, train many times.

Layout of a dataset directory::

    meta.json                      # manifest: n_rows, per-feature dtype/shape/shards
    <feature>-00000.npy            # shard 0 rows of <feature>
    <feature>-00001.npy            # ...

All features shard on the same row boundaries; each shard is a plain
C-contiguous ``.npy``.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional

import numpy as np

_META = "meta.json"


def _shard_path(path: str, name: str, k: int) -> str:
    return os.path.join(path, f"{name}-{k:05d}.npy")


class DatasetWriter:
    """Stream rows into a sharded on-disk dataset.

    Append dict-of-array row blocks of any size; shards are cut every
    ``shard_rows`` rows so dataset creation never needs the full data in
    memory. ``close()`` writes the manifest; usable as a context manager.
    """

    def __init__(self, path: str, shard_rows: int = 65536):
        if shard_rows <= 0:
            raise ValueError(f"shard_rows must be positive, got {shard_rows}")
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.shard_rows = shard_rows
        self._pending: Dict[str, List[np.ndarray]] = {}
        self._pending_rows = 0
        self._shards: List[int] = []  # rows per flushed shard
        self._features: Optional[List[str]] = None
        self._row_spec: Dict[str, tuple] = {}  # name -> (dtype, row_shape)
        self._closed = False

    def append(self, batch: Dict[str, np.ndarray]) -> None:
        names = sorted(batch)
        if self._features is None:
            self._features = names
        elif names != self._features:
            raise ValueError(
                f"feature set changed: {names} vs {self._features}")
        arrays = {k: np.asarray(v) for k, v in batch.items()}
        rows = {v.shape[0] for v in arrays.values()}
        if len(rows) != 1:
            raise ValueError(f"append rows disagree across features: {rows}")
        for k, v in arrays.items():
            spec = (v.dtype, v.shape[1:])
            expect = self._row_spec.setdefault(k, spec)
            if spec != expect:
                raise ValueError(
                    f"feature {k!r}: append dtype/row shape {spec} differs "
                    f"from earlier appends {expect}")
            # Copy: pending rows must not alias the caller's buffer — the
            # fill-one-buffer-in-a-loop pattern would otherwise silently
            # overwrite rows queued for a later shard flush.
            self._pending.setdefault(k, []).append(v.copy())
        self._pending_rows += rows.pop()
        while self._pending_rows >= self.shard_rows:
            self._flush(self.shard_rows)

    def _flush(self, rows: int) -> None:
        if rows == 0:
            return
        k = len(self._shards)
        for name in self._features or []:
            chunks, taken = [], 0
            buf = self._pending[name]
            while taken < rows:
                head = buf[0]
                need = rows - taken
                if head.shape[0] <= need:
                    chunks.append(buf.pop(0))
                    taken += head.shape[0]
                else:
                    chunks.append(head[:need])
                    buf[0] = head[need:]
                    taken += need
            arr = np.ascontiguousarray(np.concatenate(chunks, axis=0))
            np.save(_shard_path(self.path, name, k), arr)
        self._shards.append(rows)
        self._pending_rows -= rows

    def close(self) -> str:
        """Flush the ragged tail and write the manifest; returns the path."""
        if self._closed:
            return self.path
        self._flush(self._pending_rows)
        if not self._shards:
            raise ValueError("no rows were appended")
        meta: Dict = {"n_rows": int(sum(self._shards)),
                      "shard_rows": list(map(int, self._shards)),
                      "features": {}}
        for name in self._features:
            first = np.load(_shard_path(self.path, name, 0), mmap_mode="r")
            meta["features"][name] = {
                "dtype": str(first.dtype),
                "row_shape": list(first.shape[1:]),
            }
        with open(os.path.join(self.path, _META), "w") as f:
            json.dump(meta, f, indent=2, sort_keys=True)
        self._closed = True
        return self.path

    def __enter__(self) -> "DatasetWriter":
        return self

    def __exit__(self, exc_type, *_):
        if exc_type is None:
            self.close()


def write_dataset(path: str, data: Dict[str, np.ndarray],
                  shard_rows: int = 65536) -> str:
    """Write an in-memory dict-of-arrays as a sharded dataset directory."""
    with DatasetWriter(path, shard_rows=shard_rows) as w:
        w.append(data)
    return path


def slice_rows(dataset: Dict[str, List[np.ndarray]], lo: int, hi: int
               ) -> Dict[str, List[np.ndarray]]:
    """Restrict every feature's shard list to global rows ``[lo, hi)``.

    Shards are sliced as views (an ``np.memmap`` slice stays mapped), so
    this is how the ranks of a fleet read a shared on-disk dataset: every
    rank opens the same directory, then keeps only its contiguous row
    range (the per-worker feed splitting, applied at the storage layer).
    """
    if lo < 0 or hi <= lo:
        raise ValueError(f"invalid row range [{lo}, {hi})")
    out: Dict[str, List[np.ndarray]] = {}
    for name, shards in dataset.items():
        pieces, off = [], 0
        for s in shards:
            n = s.shape[0]
            a, b = max(lo - off, 0), min(hi - off, n)
            if a < b:
                pieces.append(s[a:b])
            off += n
        if hi > off:
            # Truncating silently would hand one rank fewer rows than its
            # peers: a collective deadlock later instead of an error here.
            raise ValueError(
                f"row range [{lo}, {hi}) exceeds feature {name!r} "
                f"({off} rows)")
        out[name] = pieces
    return out


def load_dataset(path: str) -> Dict[str, List[np.ndarray]]:
    """Open a dataset directory as per-feature lists of mmap'd shards.

    Returns ``{feature: [shard0, shard1, ...]}`` where every shard is an
    ``np.memmap``-backed array — no data is read until rows are gathered,
    so this works for datasets far larger than RAM. Feed the result
    directly to :class:`~autodist_tpu_torch.data.DataLoader` (or use
    ``DataLoader.from_files``).
    """
    meta_path = os.path.join(path, _META)
    if not os.path.exists(meta_path):
        raise FileNotFoundError(
            f"{path!r} is not a dataset directory (no {_META})")
    with open(meta_path) as f:
        meta = json.load(f)
    shard_rows = meta["shard_rows"]
    out: Dict[str, List[np.ndarray]] = {}
    for name, info in meta["features"].items():
        shards = []
        for k, rows in enumerate(shard_rows):
            arr = np.load(_shard_path(path, name, k), mmap_mode="r")
            if arr.shape[0] != rows:
                raise ValueError(
                    f"{name} shard {k}: {arr.shape[0]} rows, manifest says "
                    f"{rows} — dataset corrupt or partially written")
            if str(arr.dtype) != info["dtype"] or list(arr.shape[1:]) != info["row_shape"]:
                raise ValueError(
                    f"{name} shard {k}: dtype/shape {arr.dtype}{arr.shape[1:]} "
                    f"disagrees with manifest {info}")
            shards.append(arr)
        out[name] = shards
    return out
