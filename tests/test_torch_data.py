"""Port parity: the data pipeline (``autodist_tpu_torch/data/``).

The port's loader, with either engine, gives batches bitwise equal to the
JAX package's loader for the same seed, batch size, remainder setting,
epoch count, thread count and shard layout (its native engine is the
port's own build of ``csrc/dataloader.cc``, JAX's its own of
``data/native/dataloader.cc``; ``g++`` builds both here). A dataset written
by either package loads in the other byte for byte; ``augment`` and
``eval_transform`` are bitwise JAX's. The shard, validation and
memmap-not-copied cases mirror ``tests/test_data.py``. Where JAX's loader
falls back to the python engine (no compiler, a failed build, a failed
``ad_loader_create``), the port's raises, but for ``engine="auto"`` with no
compiler at all.
"""
import itertools
import json
import os
import threading
import types

import numpy as np
import pytest
import torch

from autodist_tpu.data import DataLoader as JDataLoader
from autodist_tpu.data import files as jfiles
from autodist_tpu.data import imagenet as jimagenet
from autodist_tpu.data.loader import _epoch_perm as jax_epoch_perm
from autodist_tpu_torch import api as tapi
from autodist_tpu_torch import strategy as tstrat
from autodist_tpu_torch.data import DataLoader, DatasetWriter, load_dataset, write_dataset
from autodist_tpu_torch.data import _build as data_build
from autodist_tpu_torch.data import files, imagenet
from autodist_tpu_torch.data.loader import _epoch_perm
from autodist_tpu_torch.kernel.lowering import ShardingPlan
from autodist_tpu_torch.ops import _build


def dataset(n=37, f=3, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.standard_normal((n, f)).astype(np.float32),
        "y": rng.integers(0, 10, size=(n,)).astype(np.int32),
    }


def collect(loader):
    return [{k: np.array(v, copy=True) for k, v in b.items()} for b in loader]


def assert_streams_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


@pytest.fixture(autouse=True)
def _fresh_autodist():
    tapi.AutoDist.reset_default()
    yield
    tapi.AutoDist.reset_default()


# ------------------------------------------------------------- batch order
@pytest.mark.parametrize("n,epoch,seed", [(1, 0, 0), (37, 0, 11), (64, 2, 5), (101, 1, 2**63 + 7)])
def test_epoch_permutation_is_jax_s(n, epoch, seed):
    for shuffle in (False, True):
        np.testing.assert_array_equal(_epoch_perm(n, epoch, seed, shuffle),
                                      jax_epoch_perm(n, epoch, seed, shuffle))


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("epochs", [1, 3])
def test_both_engines_bitwise_equal_jax(shuffle, drop_remainder, epochs):
    data = dataset(n=37)
    kw = dict(batch_size=8, shuffle=shuffle, seed=11, drop_remainder=drop_remainder,
              epochs=epochs)
    want = collect(JDataLoader(data, engine="python", **kw))
    assert_streams_equal(collect(JDataLoader(data, engine="native", num_threads=3, **kw)), want)
    assert_streams_equal(collect(DataLoader(data, engine="python", **kw)), want)
    for threads in (1, 2, 3, 4):
        loader = DataLoader(data, engine="native", num_threads=threads, capacity=3, **kw)
        assert loader.engine == "native"
        assert len(loader) == len(want)
        assert_streams_equal(collect(loader), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_random_shard_splits_equal_jax_whole(seed):
    """Any shard partition of the rows gives JAX's batch stream over the
    whole arrays (the C++ shard table's binary-searched gather)."""
    rng = np.random.default_rng(seed)
    data = dataset(n=int(rng.integers(60, 120)))
    n = data["x"].shape[0]
    cuts = sorted(rng.choice(np.arange(1, n), size=int(rng.integers(1, 6)), replace=False))
    bounds = [0, *cuts, n]
    sharded = {k: [v[a:b] for a, b in zip(bounds[:-1], bounds[1:])] for k, v in data.items()}
    kw = dict(batch_size=16, seed=seed, epochs=2, drop_remainder=bool(seed % 2))
    want = collect(JDataLoader(data, engine="native", **kw))
    for engine in ("native", "python"):
        assert_streams_equal(collect(DataLoader(sharded, engine=engine, num_threads=3, **kw)),
                             want)


def test_native_engine_runs_with_every_dtype_and_row_shape():
    rng = np.random.default_rng(4)
    data = {"img": rng.integers(0, 256, (30, 5, 4, 3)).astype(np.uint8),
            "f16": rng.standard_normal((30, 2)).astype(np.float16),
            "i64": rng.integers(-2**40, 2**40, 30).astype(np.int64),
            "b": rng.random((30, 7)) < 0.5}
    kw = dict(batch_size=7, seed=3, epochs=2, drop_remainder=False)
    assert_streams_equal(collect(DataLoader(data, engine="native", **kw)),
                         collect(JDataLoader(data, engine="python", **kw)))


def test_python_engine_basic_order_and_remainder():
    data = dataset(n=10)
    batches = collect(DataLoader(data, batch_size=5, shuffle=False, engine="python"))
    assert len(batches) == 2
    np.testing.assert_array_equal(batches[0]["x"], data["x"][:5])
    np.testing.assert_array_equal(batches[1]["y"], data["y"][5:10])
    data = dataset(n=37)
    drop = DataLoader(data, batch_size=10, shuffle=False)
    keep = DataLoader(data, batch_size=10, shuffle=False, drop_remainder=False)
    assert len(drop) == 3 and len(keep) == 4
    assert drop.batches_per_epoch == 3 and keep.batches_per_epoch == 4
    assert collect(keep)[-1]["x"].shape[0] == 7
    with pytest.raises(TypeError, match="infinite"):
        len(DataLoader(data, batch_size=10, epochs=-1))


def test_infinite_loader_repeats_epochs():
    data = dataset(n=16)
    it = iter(DataLoader(data, batch_size=8, seed=2, epochs=-1, engine="native"))
    got = [next(it) for _ in range(6)]
    want = collect(JDataLoader(data, batch_size=8, seed=2, epochs=3, engine="python"))
    assert_streams_equal(got, want)


def test_different_seeds_differ():
    data = dataset(n=64)
    a = collect(DataLoader(data, engine="native", batch_size=32, seed=1))
    b = collect(DataLoader(data, engine="native", batch_size=32, seed=2))
    assert not np.array_equal(a[0]["x"], b[0]["x"])


def test_native_batches_are_writeable_copies():
    data = dataset(n=16)
    batch = next(iter(DataLoader(data, batch_size=8, shuffle=False, engine="native")))
    batch["x"][:] = 0.0            # in-place mutation works, the source is untouched
    assert np.abs(data["x"][:8]).sum() > 0


# ------------------------------------------------------- native library
def test_native_without_a_compiler_raises_and_auto_takes_python(monkeypatch):
    monkeypatch.setattr(_build, "host_compiler", lambda: None)
    data = dataset(n=16)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        DataLoader(data, batch_size=8, engine="native")
    loader = DataLoader(data, batch_size=8)
    assert loader.engine == "python"
    assert_streams_equal(collect(loader), collect(JDataLoader(data, batch_size=8,
                                                              engine="python")))


def test_failed_build_raises_for_native_and_auto(monkeypatch, tmp_path):
    """A compiler that cannot run (the build pointed at a missing one)
    fails the build, and the build's failure raises: no silent python
    fallback."""
    monkeypatch.setattr(_build, "host_compiler", lambda: str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_libs", {})
    data = dataset(n=16)
    for engine in ("native", "auto"):
        with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
            DataLoader(data, batch_size=8, engine=engine)
    assert DataLoader(data, batch_size=8, engine="python").engine == "python"


def test_compiler_error_raises(monkeypatch, tmp_path):
    fake = tmp_path / "cxx"
    fake.write_text("#!/bin/sh\necho 'error: simulated' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "host_compiler", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="simulated"):
        data_build.load_library()
    assert not any(p.endswith(".so") for p in os.listdir(tmp_path / "build"))


def test_failed_loader_create_raises():
    loader = DataLoader(dataset(n=16), batch_size=8, engine="native")

    class NoCreate:
        def __getattr__(self, name):
            if name == "ad_loader_create":
                return lambda *a: None
            return getattr(loader._lib, name)

    loader._lib = NoCreate()
    with pytest.raises(RuntimeError, match="ad_loader_create failed"):
        next(iter(loader))


def test_library_is_built_once_under_its_hash():
    lib = data_build.load_library()
    assert lib is data_build.load_library()
    path = _build._lib_path("dataloader")
    assert os.path.basename(path).startswith("libdataloader-")
    assert os.path.exists(path) and os.path.dirname(path) == _build.BUILD_DIR


# --------------------------------------------------------- on-disk format
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_datasets_cross_load_byte_equal(tmp_path, writer):
    data = dataset(n=100)
    data["img"] = np.random.default_rng(1).integers(0, 256, (100, 4, 4, 3)).astype(np.uint8)
    write, load = ((write_dataset, jfiles.load_dataset) if writer == "port"
                   else (jfiles.write_dataset, load_dataset))
    write(str(tmp_path / "ds"), data, shard_rows=32)
    loaded = load(str(tmp_path / "ds"))
    assert sorted(loaded) == sorted(data)
    for k, v in data.items():
        assert [s.shape[0] for s in loaded[k]] == [32, 32, 32, 4]
        got = np.concatenate(loaded[k])
        assert got.dtype == v.dtype and got.tobytes() == v.tobytes()
    # The same directory, file for file, from either writer.
    jfiles.write_dataset(str(tmp_path / "other"), data, shard_rows=32)
    write_dataset(str(tmp_path / "mine"), data, shard_rows=32)
    names = sorted(os.listdir(tmp_path / "other"))
    assert names == sorted(os.listdir(tmp_path / "mine"))
    for name in names:
        assert ((tmp_path / "other" / name).read_bytes()
                == (tmp_path / "mine" / name).read_bytes()), name


def test_write_load_roundtrip_is_memory_mapped(tmp_path):
    data = dataset(n=100)
    write_dataset(str(tmp_path / "ds"), data, shard_rows=32)
    loaded = load_dataset(str(tmp_path / "ds"))
    assert all(isinstance(s, np.memmap) for s in loaded["x"])
    np.testing.assert_array_equal(np.concatenate(loaded["y"]), data["y"])


def test_streaming_writer_equals_whole_write(tmp_path):
    data = dataset(n=100)
    write_dataset(str(tmp_path / "whole"), data, shard_rows=30)
    with DatasetWriter(str(tmp_path / "streamed"), shard_rows=30) as w:
        for lo in range(0, 100, 7):
            w.append({k: v[lo:lo + 7] for k, v in data.items()})
    a, b = load_dataset(str(tmp_path / "whole")), load_dataset(str(tmp_path / "streamed"))
    for k in a:
        np.testing.assert_array_equal(np.concatenate(a[k]), np.concatenate(b[k]))
        assert [s.shape[0] for s in a[k]] == [s.shape[0] for s in b[k]]


@pytest.mark.parametrize("engine", ["python", "native"])
def test_file_backed_loader_equals_jax_in_memory(tmp_path, engine):
    data = dataset(n=101)
    write_dataset(str(tmp_path / "ds"), data, shard_rows=17)
    want = collect(JDataLoader(data, batch_size=16, seed=3, epochs=2, engine="python"))
    disk = DataLoader.from_files(str(tmp_path / "ds"), batch_size=16, seed=3, epochs=2,
                                 engine=engine)
    assert disk.engine == engine and len(want) == 2 * (101 // 16)
    assert_streams_equal(collect(disk), want)


def test_loader_does_not_copy_mmap_shards(tmp_path):
    write_dataset(str(tmp_path / "ds"), dataset(n=64), shard_rows=16)
    loader = DataLoader.from_files(str(tmp_path / "ds"), batch_size=8)
    for shards in loader.sources:
        assert len(shards) == 4
        for s in shards:
            assert isinstance(s, np.memmap), "shard was copied into RAM"


def test_slice_rows_across_shard_boundaries(tmp_path):
    data = dataset(n=50)
    write_dataset(str(tmp_path / "ds"), data, shard_rows=15)
    ds = load_dataset(str(tmp_path / "ds"))
    sl = files.slice_rows(ds, 10, 40)
    jsl = jfiles.slice_rows(jfiles.load_dataset(str(tmp_path / "ds")), 10, 40)
    assert [s.shape for s in sl["x"]] == [s.shape for s in jsl["x"]]
    np.testing.assert_array_equal(np.concatenate(sl["x"]), data["x"][10:40])
    assert all(s.base is not None for s in sl["x"])
    with pytest.raises(ValueError, match="exceeds"):
        files.slice_rows(ds, 40, 60)
    with pytest.raises(ValueError, match="invalid row range"):
        files.slice_rows(ds, 10, 10)


def test_from_files_process_slice_single_rank(tmp_path):
    data = dataset(n=48)
    write_dataset(str(tmp_path / "ds"), data, shard_rows=20)
    a = collect(DataLoader.from_files(str(tmp_path / "ds"), batch_size=8, seed=1))
    b = collect(DataLoader.from_files(str(tmp_path / "ds"), batch_size=8, seed=1,
                                      process_slice=True))
    assert_streams_equal(b, a)


def test_shard_and_manifest_validation(tmp_path):
    with pytest.raises(ValueError, match="dtype/row shape"):
        DataLoader({"x": [np.zeros((4, 2)), np.zeros((4, 3))]}, batch_size=2)
    with pytest.raises(ValueError, match="total rows"):
        DataLoader({"x": np.zeros((8, 2)), "y": np.zeros((7,))}, batch_size=2)
    p = str(tmp_path / "ds")
    write_dataset(p, dataset(n=40), shard_rows=20)
    meta = json.load(open(os.path.join(p, "meta.json")))
    meta["shard_rows"][0] = 19
    json.dump(meta, open(os.path.join(p, "meta.json"), "w"))
    with pytest.raises(ValueError, match="manifest"):
        load_dataset(p)
    with pytest.raises(FileNotFoundError, match="not a dataset"):
        load_dataset(str(tmp_path))


def test_constructor_validation():
    data = dataset(n=10)
    with pytest.raises(ValueError, match="batch_size"):
        DataLoader(data, batch_size=11)
    with pytest.raises(ValueError, match="leading dim"):
        DataLoader({"a": np.zeros((4, 2)), "b": np.zeros((5,))}, batch_size=2)
    with pytest.raises(ValueError, match="at least one"):
        DataLoader({}, batch_size=1)
    with pytest.raises(ValueError, match="unknown engine"):
        DataLoader(data, batch_size=2, engine="gpu")
    (batch,) = collect(DataLoader({"x": [[0.0, 1.0], [2.0, 3.0]]}, batch_size=2,
                                  shuffle=False))
    assert batch["x"].shape == (2, 2)


def test_writer_copies_buffer_and_rejects_drift(tmp_path):
    p = str(tmp_path / "ds")
    buf = np.empty((6, 2), np.float32)
    with DatasetWriter(p, shard_rows=100) as w:
        buf[:] = 1.0
        w.append({"x": buf})
        buf[:] = 2.0
        w.append({"x": buf})
    x = np.concatenate(load_dataset(p)["x"])
    np.testing.assert_array_equal(x[:6], 1.0)
    np.testing.assert_array_equal(x[6:], 2.0)
    w = DatasetWriter(str(tmp_path / "d2"), shard_rows=100)
    w.append({"x": np.zeros((4, 2), np.float32)})
    with pytest.raises(ValueError, match="differs from earlier"):
        w.append({"x": np.zeros((4, 2), np.float64)})
    w = DatasetWriter(str(tmp_path / "d3"), shard_rows=8)
    w.append({"x": np.zeros((0, 3), np.float32)})
    with pytest.raises(ValueError, match="no rows"):
        w.close()


def test_shard_list_input_without_files():
    data = dataset(n=50)
    sharded = {k: [v[:20], v[20:45], v[45:]] for k, v in data.items()}
    want = collect(JDataLoader(data, batch_size=10, seed=2, engine="python"))
    assert_streams_equal(collect(DataLoader(sharded, batch_size=10, seed=2)), want)


# ----------------------------------------------------------- augmentation
IMAGENET_CASES = [
    dict(),                                           # pad-4 reflect, random crop, flip
    dict(crop=12, seed=3),
    dict(crop=12, flip=False, seed=4),
    dict(pad=0, normalize=False, seed=5),
    dict(crop=10, stds=imagenet.CHANNEL_STDS, seed=6),
]


@pytest.mark.parametrize("kw", IMAGENET_CASES, ids=lambda kw: ",".join(kw) or "default")
def test_augment_bitwise_jax(kw):
    rng = np.random.default_rng(0)
    batch = {"image": rng.integers(0, 256, (6, 16, 16, 3)).astype(np.uint8),
             "label": np.arange(6, dtype=np.int32)}
    for step in (0, 5, 6):
        got = imagenet.augment(**kw)(dict(batch), step)
        want = jimagenet.augment(**kw)(dict(batch), step)
        assert_streams_equal([got], [want])
    a, b = imagenet.augment(seed=7)(dict(batch), 5), imagenet.augment(seed=7)(dict(batch), 6)
    assert not np.array_equal(a["image"], b["image"])


@pytest.mark.parametrize("kw", [dict(), dict(crop=12), dict(crop=9, stds=imagenet.CHANNEL_STDS),
                                dict(crop=12, normalize=False)])
def test_eval_transform_bitwise_jax(kw):
    rng = np.random.default_rng(1)
    batch = {"image": rng.integers(0, 256, (4, 16, 16, 3)).astype(np.uint8)}
    got = imagenet.eval_transform(**kw)(dict(batch), 3)
    assert_streams_equal([got], [jimagenet.eval_transform(**kw)(dict(batch), 0)])
    assert got["image"].dtype == np.float32


def test_augmented_file_loader_equals_jax(tmp_path):
    rng = np.random.default_rng(2)
    data = {"images": rng.integers(0, 256, (40, 12, 12, 3)).astype(np.uint8),
            "labels": rng.integers(0, 1000, 40).astype(np.int32)}
    write_dataset(str(tmp_path / "ds"), data, shard_rows=16)
    kw = dict(batch_size=8, seed=9, epochs=2)
    got = collect(DataLoader.from_files(str(tmp_path / "ds"), engine="native",
                                        transform=imagenet.augment("images", crop=8, seed=1),
                                        **kw))
    want = collect(JDataLoader.from_files(str(tmp_path / "ds"), engine="python",
                                          transform=jimagenet.augment("images", crop=8,
                                                                      seed=1), **kw))
    assert_streams_equal(got, want)
    assert got[0]["images"].shape == (8, 8, 8, 3)


def test_transform_hook_applied_and_step_indexed():
    data = dataset(n=32)
    seen = []

    def transform(batch, step):
        seen.append(step)
        return {k: (v + 1 if k == "x" else v) for k, v in batch.items()}

    plain = collect(DataLoader(data, batch_size=8, seed=1))
    transformed = collect(DataLoader(data, batch_size=8, seed=1, transform=transform))
    assert seen == [0, 1, 2, 3]
    for p, t in zip(plain, transformed):
        np.testing.assert_array_equal(p["x"] + 1, t["x"])


# ------------------------------------------------------ plan and devices
def _plan_and_data():
    def loss_fn(params, batch):
        return ((batch["x"] @ params["w"]) ** 2).mean()

    data = dataset(n=64)
    ad = tapi.AutoDist(strategy_builder=tstrat.AllReduce(), device="cpu")
    step = ad.build(loss_fn, {"w": torch.zeros((3, 1))},
                    {"x": torch.from_numpy(data["x"][:16]), "y": torch.from_numpy(data["y"][:16])})
    return step.plan, data


@pytest.mark.parametrize("prefetch", [0, 2])
def test_plan_binding_yields_tensors_on_the_device(prefetch):
    plan, data = _plan_and_data()
    want = collect(JDataLoader(data, batch_size=16, seed=4, epochs=2, engine="python"))
    got = list(DataLoader(data, batch_size=16, seed=4, epochs=2, plan=plan,
                          device_prefetch=prefetch))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in w:
            assert isinstance(g[k], torch.Tensor) and g[k].device == plan.device
            np.testing.assert_array_equal(g[k].numpy(), w[k])


def test_window_from_local_and_window_shardings():
    plan, data = _plan_and_data()
    stacked = {"x": np.stack([data["x"][:16], data["x"][16:32]]), "y": np.zeros((2, 1))}
    window = plan.window_from_local(stacked)
    assert isinstance(window["x"], torch.Tensor) and window["x"].shape == (2, 16, 3)
    np.testing.assert_array_equal(window["x"].numpy(), stacked["x"])
    assert plan.window_shardings(window) == {"x": "PartitionSpec(None, 'data')",
                                             "y": "PartitionSpec(None,)"}
    host = list(DataLoader(data, batch_size=16, seed=4, plan=plan).host_batches())
    assert isinstance(host[0]["x"], np.ndarray) and len(host) == 4


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "DataLoader-prefetch"]


@pytest.mark.parametrize("engine", ["python", "native"])
def test_device_prefetch_transforms_on_its_thread_and_stops(engine):
    """``device_prefetch`` runs the gather and the transform on its producer
    thread, gives the plain plan path's batches, and stops and joins the
    thread when the consumer drops the iterator early."""
    plan, data = _plan_and_data()
    seen = []

    def transform(batch, step):
        seen.append(threading.current_thread().name)
        return {"x": batch["x"] * 2 + step, "y": batch["y"]}

    def loader(prefetch):
        return DataLoader(data, batch_size=16, seed=4, epochs=3, plan=plan, engine=engine,
                          transform=transform, device_prefetch=prefetch)

    plain = list(loader(0))
    assert set(seen) == {threading.current_thread().name}
    seen.clear()
    got = list(loader(2))
    assert set(seen) == {"DataLoader-prefetch"} and len(got) == len(plain) == 12
    for g, w in zip(got, plain):
        for k in w:
            assert torch.equal(g[k], w[k])
    it = iter(loader(2))
    head = list(itertools.islice(it, 2))
    assert all(torch.equal(g["x"], w["x"]) for g, w in zip(head, plain))
    del it
    assert not _prefetch_threads()


def test_device_prefetch_reraises_a_transform_error():
    plan, data = _plan_and_data()

    def transform(batch, step):
        if step == 2:
            raise RuntimeError("bad batch 2")
        return batch

    loader = DataLoader(data, batch_size=16, seed=4, plan=plan, transform=transform,
                        device_prefetch=2)
    got = []
    with pytest.raises(RuntimeError, match="bad batch 2"):
        for b in loader:
            got.append(b)
    assert len(got) == 2 and not _prefetch_threads()


def test_window_shardings_raises_on_a_slice_the_data_axis_does_not_divide():
    plan = types.SimpleNamespace(mesh=types.SimpleNamespace(data_size=2))
    assert ShardingPlan.window_shardings(plan, {"x": torch.zeros(3, 4, 2)}) == {
        "x": "PartitionSpec(None, 'data')"}
    with pytest.raises(ValueError, match="not divisible"):
        ShardingPlan.window_shardings(plan, {"x": torch.zeros(3, 5, 2)})
