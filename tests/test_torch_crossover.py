"""Port parity: the measured attention crossovers (``ops/crossover.py``).

The port's four functions against the JAX package's
(``autodist_tpu/ops/crossover.py``) on the same table files: the JAX
package's own v5e tables, the port's H100 tables, and made-up ones (a
missing file, a corrupt one, one where flash never wins, one where it
wins, loses and wins again, several (batch, heads) buckets). Both
packages' ``resolve_*`` read their packaged paths, which the tests point
at each table (JAX's paged rule at a "tpu" backend, where it reads the
table; the port's on a CUDA device).
On the CPU, "auto" resolves as before: flash from 1024 when aligned, the
paged gather. The packaged H100 tables carry the card's name and power
limit on every row and put bert_base's 512 on flash; the flash table
decides only for its own dtype (bf16), and the paged one takes each
measured point's winner, down to a one-page timeline.
"""
import json
import os

import pytest
import torch

from autodist_tpu.ops import crossover as jx
from autodist_tpu_torch.models import transformer as tt
from autodist_tpu_torch.ops import crossover as pt
from autodist_tpu_torch.ops import paged_attention as tpa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FLASH = os.path.join(REPO, "docs", "measured", "flash_crossover.json")
JAX_PAGED = os.path.join(REPO, "docs", "measured", "paged_crossover.json")
SEQS = (64, 128, 256, 384, 500, 512, 640, 1024, 2048, 4096)
BUCKETS = [(1, 12), (8, 8), (8, 12), (20, 12), (32, 12), (64, 16), (None, None)]


def _flash_rows(points):
    return {"rows": [{"seq": s, "impl": impl, "tokens_per_sec": r}
                     for s, (dot, flash) in points.items()
                     for impl, r in (("dot", dot), ("flash", flash))]}


def _paged_rows(points):
    return {"rows": [{"batch": b, "table_pages": tp, "page_len": 16, "heads": h,
                      "impl": impl, "tokens_per_sec": r}
                     for (b, h, tp), (gather, kernel) in points.items()
                     for impl, r in (("gather", gather), ("kernel", kernel))]}


def _write(tmp_path, name, payload):
    path = str(tmp_path / name)
    with open(path, "w", encoding="utf-8") as f:
        if isinstance(payload, str):
            f.write(payload)
        else:
            json.dump(payload, f)
    return path


@pytest.fixture
def tables(tmp_path):
    """Table files by case: JAX's, the port's, and made-up ones."""
    return {
        "jax": (JAX_FLASH, JAX_PAGED),
        "port": (pt.FLASH_TABLE, pt.PAGED_TABLE),
        "missing": (str(tmp_path / "none.json"),) * 2,
        "corrupt": (_write(tmp_path, "bad_f.json", "{not json"),
                    _write(tmp_path, "bad_p.json", '{"rows": [{"batch": 8}]}')),
        "never": (_write(tmp_path, "never_f.json",
                         _flash_rows({512: (2.0, 1.0), 1024: (2.0, 1.5)})),
                  _write(tmp_path, "never_p.json",
                         _paged_rows({(8, 12, 8): (2.0, 1.0), (8, 12, 64): (2.0, 1.0)}))),
        "relapse": (_write(tmp_path, "relapse_f.json",
                           _flash_rows({256: (1.0, 2.0), 512: (2.0, 1.0),
                                        1024: (1.0, 2.0), 2048: (1.0, 3.0)})),
                    _write(tmp_path, "relapse_p.json",
                           _paged_rows({(8, 12, 4): (1.0, 2.0), (8, 12, 16): (2.0, 1.0),
                                        (8, 12, 64): (1.0, 2.0), (32, 12, 4): (1.0, 2.0),
                                        (32, 12, 16): (1.0, 2.0), (64, 16, 64): (2.0, 1.0),
                                        (64, 16, 128): (1.0, 2.0)}))),
    }


CASES = ("jax", "port", "missing", "corrupt", "never", "relapse")


@pytest.mark.parametrize("case", CASES)
def test_flash_crossover_seq_equals_jax(tables, case):
    path = tables[case][0]
    assert pt.flash_crossover_seq(path) == jx.flash_crossover_seq(path)


@pytest.mark.parametrize("case", CASES)
def test_paged_crossover_timeline_equals_jax(tables, case):
    path = tables[case][1]
    for batch, heads in BUCKETS:
        assert (pt.paged_crossover_timeline(batch, heads, path)
                == jx.paged_crossover_timeline(batch, heads, path)), (batch, heads)


@pytest.mark.parametrize("case", CASES)
def test_resolve_rules_equal_jax_on_a_measured_device(tables, case, monkeypatch):
    """JAX's rules read the table on its accelerator; the port's on CUDA.
    Both packages' packaged paths point at the case's tables."""
    flash, paged = tables[case]
    monkeypatch.setattr(jx, "_measured_path", lambda: flash)
    monkeypatch.setattr(jx, "_paged_measured_path", lambda: paged)
    monkeypatch.setattr(jx, "_cache", {})
    monkeypatch.setattr(pt, "FLASH_TABLE", flash)
    monkeypatch.setattr(pt, "PAGED_TABLE", paged)
    monkeypatch.setattr(pt, "_cache", {})
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for seq in SEQS:
        for impl in ("auto", "dot", "flash"):
            assert (pt.resolve_attention_impl(impl, seq, "cuda", torch.bfloat16)
                    == jx.resolve_attention_impl(impl, seq)), (impl, seq)
    for batch, heads in [(1, 12), (8, 12), (32, 12), (64, 16)]:
        for table_pages in (1, 2, 4, 8, 16, 32, 64, 256):
            for impl in ("auto", "gather", "kernel"):
                got = pt.resolve_paged_impl(impl, batch, table_pages, 16, heads,
                                            device="cuda")
                assert got == jx.resolve_paged_impl(impl, batch, table_pages, 16, heads), \
                    (impl, batch, table_pages, heads)


def test_cpu_auto_resolves_as_before():
    """On the CPU: flash from the packaged 1024 when aligned (the table is
    not read), the paged gather at every shape."""
    for seq in SEQS:
        want = "flash" if seq >= 1024 and seq % 128 == 0 else "dot"
        assert pt.resolve_attention_impl("auto", seq, "cpu") == want
        assert pt.resolve_attention_impl("auto", seq) == want
        assert tt.resolve_attention_impl("auto", seq, "cpu") == jx.resolve_attention_impl(
            "auto", seq) == want
    for table_pages in (1, 4, 32, 256):
        assert pt.resolve_paged_impl("auto", 32, table_pages, 16, 12, device="cpu") == "gather"
        assert tpa.resolve_impl("auto", "cpu", batch=32, table_pages=table_pages,
                                page_len=16, heads=12) == "gather"


def test_packaged_h100_tables():
    """Every row names the card and its power limit; on CUDA bert_base's
    seq 512 takes flash and the serve runs' decode shape the kernel, as
    the tables say."""
    for path in (pt.FLASH_TABLE, pt.PAGED_TABLE):
        with open(path, encoding="utf-8") as f:
            rows = json.load(f)["rows"]
        assert rows and all(r["device"].startswith("NVIDIA") and r["power_limit"].endswith("W")
                            for r in rows)
    seq = pt.flash_crossover_seq()
    assert seq <= 512 and seq == jx.flash_crossover_seq(pt.FLASH_TABLE)
    assert pt.resolve_attention_impl("auto", 512, "cuda", torch.bfloat16) == "flash"
    assert tt.resolve_attention_impl("auto", 512, "cuda", torch.bfloat16) == "flash"
    timeline = pt.paged_crossover_timeline(32, 12)
    want = "kernel" if 32 * 16 >= timeline else "gather"
    assert tpa.resolve_impl("auto", "cuda", batch=32, table_pages=32, page_len=16,
                            heads=12) == want


def test_packaged_paged_table_picks_each_measured_winner():
    """On CUDA, "auto" takes the faster path of every measured point of
    the packaged paged table, down to a one-page timeline (16 positions)."""
    with open(pt.PAGED_TABLE, encoding="utf-8") as f:
        rows = json.load(f)["rows"]
    points: dict = {}
    for r in rows:
        points.setdefault((r["batch"], r["table_pages"], r["page_len"], r["heads"]),
                          {})[r["impl"]] = r["tokens_per_sec"]
    assert min(tp * pl for _, tp, pl, _ in points) == 16
    for (batch, table_pages, page_len, heads), rate in points.items():
        winner = "kernel" if rate["kernel"] >= rate["gather"] else "gather"
        assert pt.resolve_paged_impl("auto", batch, table_pages, page_len, heads,
                                     device="cuda") == winner, (batch, table_pages)
        assert tpa.resolve_impl("auto", "cuda", batch, table_pages, page_len,
                                heads) == winner, (batch, table_pages)


def test_flash_table_decides_only_its_dtype(monkeypatch):
    """The packaged H100 flash table was measured in bf16: it decides for
    bf16 attention on CUDA; fp32 attention, or a call that names no dtype,
    resolves against the packaged 1024. A table that records no dtype (the
    JAX package's) decides for every dtype."""
    assert pt._flash_table()[1] == "bfloat16"
    for seq in SEQS:
        aligned = seq % 128 == 0
        want_bf16 = "flash" if seq >= pt.flash_crossover_seq() and aligned else "dot"
        want_default = "flash" if seq >= 1024 and aligned else "dot"
        assert pt.resolve_attention_impl("auto", seq, "cuda", torch.bfloat16) == want_bf16
        assert pt.resolve_attention_impl("auto", seq, "cuda", "bfloat16") == want_bf16
        assert pt.resolve_attention_impl("auto", seq, "cuda", torch.float32) == want_default
        assert pt.resolve_attention_impl("auto", seq, "cuda") == want_default
        assert tt.resolve_attention_impl("auto", seq, "cuda", torch.float32) == want_default
    monkeypatch.setattr(pt, "FLASH_TABLE", JAX_FLASH)
    monkeypatch.setattr(pt, "_cache", {})
    for seq in SEQS:
        for dtype in (torch.float32, torch.bfloat16, None):
            want = "flash" if seq >= jx.flash_crossover_seq(JAX_FLASH) and seq % 128 == 0 \
                else "dot"
            assert pt.resolve_attention_impl("auto", seq, "cuda", dtype) == want, (seq, dtype)
