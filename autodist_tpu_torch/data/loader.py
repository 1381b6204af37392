"""DataLoader: prefetched, shuffled batches from in-memory or on-disk rows
(PyTorch port of the JAX package's ``data/loader.py``).

A facade over two engines with the same semantics:

- **native**: the multi-threaded row-gather pipeline of
  ``csrc/dataloader.cc``: C++ threads assemble batches without the GIL
  while the device runs the previous step;
- **python**: plain numpy gathering, the same batch order bit for bit (the
  shuffle is splitmix64-based in both), the test oracle of the native one.

``engine="auto"`` takes the native engine whenever a host C++ compiler is
found, and then a build or a loader that fails raises; only where no
compiler is found at all does it take the python engine. ``engine="native"``
raises when the library is unavailable. ``loader.engine`` says which runs.
The batch order, and the batches, are those of the JAX package's loader for
the same seed, batch size, remainder setting and epoch count, whatever the
engine, thread count or shard layout.

Each feature may be one array or a list of row-shard arrays; sharded
``np.memmap`` features (``DataLoader.from_files``, ``files.load_dataset``)
stream larger-than-RAM datasets from the page cache, never copied.

Without ``plan`` the loader yields numpy batches. With a
:class:`~autodist_tpu_torch.kernel.lowering.ShardingPlan` it yields the
global batch as tensors on the plan's device: each rank's batch is its rows
of it, all-gathered over the data group
(``ShardingPlan.global_batch_from_local``). A "process" of the JAX package
is a ``torch.distributed`` rank here (one process per GPU): ``process_slice``
and the ragged-tail check read the default group's world size and rank.
``device_prefetch=N`` keeps ``N`` host-to-device copies in flight, each from
pinned host memory with ``non_blocking=True``, on a copy stream, and moves
the gather and the transform onto a producer thread; a pinned buffer is
dropped only once its copy has finished.
"""
from __future__ import annotations

import contextlib
import ctypes
import queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from autodist_tpu_torch.data import _build
from autodist_tpu_torch.models.convert import to_tensor


def _splitmix64(x: int) -> tuple:
    x = (x + 0x9E3779B97F4A7C15) & (2**64 - 1)
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2**64 - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2**64 - 1)
    return x, z ^ (z >> 31)


def _epoch_perm(n_rows: int, epoch: int, seed: int, shuffle: bool) -> np.ndarray:
    """The exact permutation the native engine uses (dataloader.cc EpochPerm)."""
    perm = np.arange(n_rows, dtype=np.uint64)
    if not shuffle:
        return perm
    s = (seed ^ ((0x5851F42D4C957F2D * (epoch + 1)) & (2**64 - 1))) & (2**64 - 1)
    for i in range(n_rows - 1, 0, -1):
        s, r = _splitmix64(s)
        j = r % (i + 1)
        perm[i], perm[j] = perm[j], perm[i]
    return perm


def process_count_index() -> Tuple[int, int]:
    """``(world size, rank)`` of the default ``torch.distributed`` group;
    ``(1, 0)`` without one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class DataLoader:
    """Iterate dict-of-arrays data as prefetched batches.

    ``data``: mapping name -> np.ndarray (or list of row-shard arrays, e.g.
    the mmap'd shards from ``files.load_dataset``), all with equal total
    rows. ``epochs``: -1 repeats forever. ``plan``: optional ShardingPlan;
    when given, batches come back as tensors of the global batch on its
    device. ``transform``: optional host-side ``f(batch, step) -> batch``
    hook applied to every gathered batch before the device transfer (the
    decode/augment stage, see ``data/imagenet.py``); it must be
    deterministic in ``(batch, step)`` so that every rank agrees.
    """

    def __init__(
        self,
        data: Dict[str, Any],
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = True,
        epochs: int = 1,
        capacity: int = 4,
        num_threads: int = 2,
        engine: str = "auto",      # auto | native | python
        plan: Any = None,
        device_prefetch: int = 0,
        transform: Optional[Callable[[Dict[str, np.ndarray], int], Dict[str, np.ndarray]]] = None,
    ):
        if not data:
            raise ValueError("data must have at least one feature array")
        self.names = sorted(data)
        # Every feature as a list of row shards. Contiguous arrays, np.memmap
        # shards among them, are kept as they are: never copied into RAM.
        self.sources: List[List[np.ndarray]] = []
        for k in self.names:
            v = data[k]
            # A list/tuple is a shard list only when every element is an
            # ndarray: a nested python list like [[0, 1], [2, 3]] is one
            # array-like, not two scalar-row shards.
            if (isinstance(v, (list, tuple)) and v
                    and all(isinstance(s, np.ndarray) for s in v)):
                shards = list(v)
            else:
                shards = [np.asarray(v)]
            if not all(s.ndim >= 1 for s in shards):
                raise ValueError(f"feature {k!r} shards must have a row dim")
            shards = [
                s if (isinstance(s, np.ndarray) and s.flags.c_contiguous)
                else np.ascontiguousarray(s)
                for s in shards
            ]
            tails = {(s.dtype, s.shape[1:]) for s in shards}
            if len(tails) != 1:
                raise ValueError(
                    f"feature {k!r} shards disagree on dtype/row shape: {tails}")
            self.sources.append(shards)
        self.transform = transform
        n_rows = {sum(s.shape[0] for s in shards) for shards in self.sources}
        if len(n_rows) != 1:
            raise ValueError(
                f"feature arrays disagree on total rows (leading dims): {n_rows}")
        self.n_rows = n_rows.pop()
        # Per-feature prefix-sum shard offsets (the python engine's gather).
        self._offsets = [
            np.cumsum([0] + [s.shape[0] for s in shards])[:-1]
            for shards in self.sources
        ]
        if batch_size <= 0 or batch_size > self.n_rows:
            raise ValueError(
                f"batch_size {batch_size} invalid for {self.n_rows} rows"
            )
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.epochs = epochs
        self.capacity = capacity
        self.num_threads = num_threads
        self.plan = plan
        self.device_prefetch = device_prefetch

        if engine not in ("auto", "native", "python"):
            raise ValueError(
                f"unknown engine {engine!r}; choose auto, native or python"
            )
        if engine == "native" and not _build.native_available():
            raise RuntimeError("native engine requested but no C++ compiler was found "
                               "to build csrc/dataloader.cc")
        native = engine == "native" or (engine == "auto" and _build.native_available())
        self._lib = _build.load_library() if native else None
        self.engine = "native" if native else "python"

    @property
    def batches_per_epoch(self) -> int:
        full = self.n_rows // self.batch_size
        if self.drop_remainder or self.n_rows % self.batch_size == 0:
            return full
        return full + 1

    def __len__(self) -> int:
        if self.epochs < 0:
            raise TypeError("infinite loader has no len()")
        return self.epochs * self.batches_per_epoch

    # ------------------------------------------------------------------- iter
    def _check_multihost_remainder(self) -> None:
        if (process_count_index()[0] > 1 and not self.drop_remainder
                and self.n_rows % self.batch_size):
            raise ValueError(
                "multi-rank DataLoader requires drop_remainder=True: a "
                "ragged final batch cannot assemble into a global batch")

    def _with_transform(self, it) -> Iterator[Dict[str, np.ndarray]]:
        if self.transform is None:
            yield from it
            return
        for step, batch in enumerate(it):
            yield self.transform(batch, step)

    def _host_iter(self, pin: bool = False) -> Iterator[Dict[str, np.ndarray]]:
        return self._with_transform(
            self._iter_native(pin) if self.engine == "native" else self._iter_python())

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        pin = (self.plan is not None and self.device_prefetch > 0
               and self.plan.device.type == "cuda")
        it = self._host_iter(pin)
        if self.plan is None:
            return it
        self._check_multihost_remainder()
        if self.device_prefetch > 0:
            return self._iter_device_prefetch(it, self.device_prefetch)
        return (self.plan.global_batch_from_rows(b) for b in it)

    def host_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        """Raw per-rank host batches, no device transfer.

        The windowed-fit bridge (``DistributedTrainStep.fit(window=k)``)
        stacks ``k`` of these and ships one transfer per window
        (``ShardingPlan.window_from_local``): stacking happens before the
        device copy, so this bypasses the per-batch path. The multi-rank
        ragged-tail contract is ``__iter__``'s: a final batch that cannot
        assemble into a global batch fails here, not inside window assembly.
        """
        self._check_multihost_remainder()
        return self._host_iter()

    @classmethod
    def from_files(cls, data_dir: str, batch_size: int,
                   process_slice: bool = False, **kwargs) -> "DataLoader":
        """Open a ``files.write_dataset`` directory as a streaming loader.

        Every shard arrives as an ``np.memmap`` view; rows are gathered
        straight from the page cache, so the dataset may be far larger than
        RAM.

        ``process_slice=True`` is the multi-rank recipe: every rank opens the
        same (shared-filesystem) directory but keeps only its contiguous
        ``n_rows / world size`` row range, so the ranks' local batches
        assemble into disjoint global batches through ``plan``. The world
        size must divide the row count.
        """
        from autodist_tpu_torch.data.files import load_dataset, slice_rows

        data = load_dataset(data_dir)
        if process_slice:
            P, p = process_count_index()
            n = sum(s.shape[0] for s in next(iter(data.values())))
            if n % P:
                raise ValueError(
                    f"process_slice needs rows % ranks == 0; "
                    f"{n} rows over {P} ranks")
            rpp = n // P
            data = slice_rows(data, p * rpp, (p + 1) * rpp)
        return cls(data, batch_size, **kwargs)

    # ----------------------------------------------------------- to device
    def _put(self, batch: Dict[str, np.ndarray], stream):
        """Start the host-to-device copy of ``batch``: ``(device tensors,
        copy-done event, pinned host tensors)``. A leaf that already lies in
        pinned memory (the native engine's batches under ``device_prefetch``,
        and what a transform passes through) is copied from where it is; any
        other is first copied into a pinned buffer. On the CPU the tensors
        are the host ones."""
        host = {k: to_tensor(v) for k, v in batch.items()}
        if stream is None:
            return host, None, None
        pinned = {k: t if t.is_pinned() else
                  torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
                  for k, t in host.items()}
        with torch.cuda.stream(stream):
            moved = {k: t.to(stream.device, non_blocking=True) for k, t in pinned.items()}
            done = torch.cuda.Event()
            done.record(stream)
        return moved, done, pinned

    def _iter_device_prefetch(self, it, depth: int):
        """Keep ``depth`` host-to-device copies in flight ahead of the
        consumer. One producer thread pulls the host batches (the gather and
        ``transform`` run there, beside the consumer's step) and starts each
        batch's copy on a side stream from pinned memory; the consumer's
        stream waits for the copy's event before the batch is assembled, and
        the pinned buffer is kept until the event has completed, so it is
        never released while its copy runs. The thread is stopped and joined
        when the iterator ends or is dropped."""
        dev = self.plan.device
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        q: queue.Queue = queue.Queue(maxsize=depth)
        stop = threading.Event()
        end = object()

        def offer(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def produce():
            try:
                with torch.cuda.device(dev) if stream is not None else contextlib.nullcontext():
                    for b in it:
                        if not offer(self._put(b, stream)):
                            return
                offer(end)
            except BaseException as e:     # re-raised on the consumer's thread
                offer(e)
            finally:
                it.close()

        worker = threading.Thread(target=produce, name="DataLoader-prefetch", daemon=True)
        worker.start()
        held = []
        try:
            while True:
                item = q.get()
                if item is end:
                    return
                if isinstance(item, BaseException):
                    raise item
                moved, done, pinned = item
                if done is not None:
                    current = torch.cuda.current_stream(dev)
                    current.wait_event(done)
                    for t in moved.values():
                        t.record_stream(current)
                    held.append((done, pinned))
                held[:] = [(e, p) for e, p in held if not e.query()]
                yield self.plan.global_batch_from_rows(moved)
        finally:
            stop.set()
            worker.join()

    # ------------------------------------------------------------- engines
    def _gather(self, i: int, idx: np.ndarray) -> np.ndarray:
        """Gather global rows ``idx`` of feature ``i`` across its shards."""
        shards = self.sources[i]
        if len(shards) == 1:
            return shards[0][idx]
        offsets = self._offsets[i]
        which = np.searchsorted(offsets, idx, side="right") - 1
        out = np.empty((len(idx),) + shards[0].shape[1:], shards[0].dtype)
        for s in np.unique(which):
            m = which == s
            out[m] = shards[s][idx[m] - offsets[s]]
        return out

    def _iter_python(self):
        total = None if self.epochs < 0 else self.epochs
        epoch = 0
        while total is None or epoch < total:
            perm = _epoch_perm(self.n_rows, epoch, self.seed, self.shuffle)
            for b in range(self.batches_per_epoch):
                idx = perm[b * self.batch_size:(b + 1) * self.batch_size]
                idx = idx.astype(np.int64)
                yield {
                    name: self._gather(i, idx)
                    for i, name in enumerate(self.names)
                }
            epoch += 1

    def _iter_native(self, pin: bool = False):
        """The native engine's batches; with ``pin`` each leaf is copied out
        of its slot straight into pinned host memory (``device_prefetch``'s
        copy source), else into a numpy array."""
        lib = self._lib
        h = lib.ad_loader_create(
            len(self.sources), self.n_rows, self.batch_size, self.capacity,
            self.num_threads, int(self.shuffle), self.seed,
            int(self.drop_remainder), self.epochs,
        )
        if not h:
            raise RuntimeError(
                f"ad_loader_create failed ({len(self.sources)} features, "
                f"{self.n_rows} rows, batch {self.batch_size})")
        try:
            for i, shards in enumerate(self.sources):
                head = shards[0]
                row_bytes = head.dtype.itemsize * int(
                    np.prod(head.shape[1:], dtype=np.int64))
                if len(shards) == 1:
                    lib.ad_loader_set_source(
                        h, i, head.ctypes.data_as(ctypes.c_void_p), row_bytes
                    )
                else:
                    bases = (ctypes.c_void_p * len(shards))(
                        *[s.ctypes.data_as(ctypes.c_void_p).value for s in shards]
                    )
                    srows = (ctypes.c_uint64 * len(shards))(
                        *[s.shape[0] for s in shards]
                    )
                    rc = lib.ad_loader_set_source_shards(
                        h, i, bases, srows, len(shards), row_bytes
                    )
                    if rc != 0:
                        raise RuntimeError(
                            f"native loader rejected shard table for "
                            f"{self.names[i]!r}"
                        )
            if lib.ad_loader_start(h) != 0:
                raise RuntimeError("native loader failed to start")
            ptrs = (ctypes.c_void_p * len(self.sources))()
            rows = ctypes.c_uint64()
            while True:
                slot = lib.ad_loader_next(h, ptrs, ctypes.byref(rows))
                if slot < 0:
                    break
                n = int(rows.value)
                batch = {}
                for i, name in enumerate(self.names):
                    head = self.sources[i][0]
                    shape = (n,) + head.shape[1:]
                    nbytes = head.dtype.itemsize * int(np.prod(shape, dtype=np.int64))
                    # One copy out of the slot: frees it for immediate refill
                    # and yields a writeable array like the python engine's
                    # fancy-indexed copies.
                    view = (ctypes.c_uint8 * nbytes).from_address(ptrs[i])
                    out = (torch.empty(nbytes, dtype=torch.uint8, pin_memory=True).numpy()
                           .view(head.dtype).reshape(shape) if pin
                           else np.empty(shape, head.dtype))
                    np.copyto(out, np.frombuffer(view, dtype=head.dtype).reshape(shape))
                    batch[name] = out
                lib.ad_loader_release(h, int(slot))
                yield batch
        finally:
            lib.ad_loader_destroy(h)
