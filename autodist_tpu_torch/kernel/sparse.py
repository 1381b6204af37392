"""The touched-rows wire of a sparse table split by rows over the data axis.

The JAX package row-shards a sparse-update table (an embedding) over the
data axis, and GSPMD turns its row gather and the gradient's scatter-add
into collectives the size of the step's tokens, never of the table
(``tests/test_sparse_wire.py``). The port renders the same wire by hand:
the step hands the loss this rank's row block wrapped as a
:class:`RowSplitTable`, and every row read of it runs
:class:`SparseRowLookup`:

- **forward**: the ranks' ids are all-gathered (int32), once a forward
  for every table read with the same ids tensor (NCF reads two tables
  with its user ids and two with its item ids); each rank gathers the
  rows it holds for all ``n x T`` ids, zeros for the rest, and a sum
  reduce-scatter along the token axis hands each rank its own ``[T, ...]``
  rows (exactly one rank holds a row, so the sum is exact in any dtype);
- **backward**: the output gradients are all-gathered and each rank
  ``index_add``s them, times ``1/n`` (the mean over ranks of the ranks'
  local mean losses), into the rows it holds. The block's gradient is then
  whole: dense and block-shaped, what the optimizer, the staleness buffer
  and the checkpoint see for a row-split variable.

The wire is ``O(n T E)``, whatever the vocabulary. Row reads are
``layers.embedding_lookup``, ``table[ids]`` (an integer tensor index),
``F.embedding`` and ``index_select`` along dim 0. An id outside the table
fails as the plain read fails: on the CPU every rank raises
``IndexError`` (each rank checks the same gathered ids, so all raise
there, with no collective left pending), on CUDA a device-side assert
fires, as plain indexing's does, without a host synchronize. A negative
id of ``table[ids]`` and ``embedding_lookup`` counts from the end, as
plain indexing does; the padding rows of a padded table never see an id.
Any other use of the table (the tied output projection of the
transformer and the MoE, a transpose, arithmetic) all-gathers the block
through :class:`_GatherTable`, whose backward reduce-scatters the table's
gradient (mean); that wire is table-sized, as it is in the JAX package's
GSPMD program. Row reads count their collectives under the purpose
``"sparse"``, whole-table uses under ``"table"``.

A :class:`RowSplitTable` made without a ``coll`` only records its uses
(:attr:`RowSplitTable.uses`) and returns meta tensors: the step's wire
prediction traces the loss so (``DistributedTrainStep.predicted_bytes``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

#: Purposes the collectives of a row-split table are counted under.
SPARSE_PURPOSE = "sparse"
TABLE_PURPOSE = "table"


class SparseRowLookup(torch.autograd.Function):
    """Rows ``all_ids`` (every rank's ids, gathered and checked) of a table
    split by rows over ``coll``'s group, from this rank's ``block`` (rows
    ``lo .. lo + len(block)`` of the whole): this rank's share of them
    after the reduce-scatter; see the module docstring."""

    @staticmethod
    def forward(ctx, block, all_ids, coll, lo: int):
        local = all_ids - lo
        idx = local.clamp(0, block.shape[0] - 1)
        held = (idx == local).view((-1,) + (1,) * (block.dim() - 1))
        rows = torch.where(held, block.index_select(0, idx), 0.0)
        ctx.save_for_backward(idx, held)
        ctx.coll, ctx.block_shape = coll, tuple(block.shape)
        return coll.reduce_scatter(rows, 0, SPARSE_PURPOSE, mean=False)

    @staticmethod
    def backward(ctx, grad):
        idx, held = ctx.saved_tensors
        coll = ctx.coll
        all_g = coll.all_gather(grad.contiguous(), 0, SPARSE_PURPOSE)
        out = torch.zeros(ctx.block_shape, dtype=grad.dtype, device=grad.device)
        return (out.index_add_(0, idx, torch.where(held, all_g, 0.0), alpha=1.0 / coll.size),
                None, None, None)


def _checked(all_ids: torch.Tensor, vocab: int, wrap: bool) -> torch.Tensor:
    """``all_ids`` held to a table of ``vocab`` rows (module docstring),
    a negative id counted from the end when ``wrap``."""
    low = -vocab if wrap else 0
    if all_ids.is_cuda:
        torch._assert_async(((all_ids >= low) & (all_ids < vocab)).all(),
                            f"an id of a row-split table outside [{low}, {vocab})")
    elif all_ids.numel():
        first, last = (int(v) for v in torch.aminmax(all_ids))
        if first < low or last >= vocab:
            raise IndexError(f"index {first if first < low else last} is out of bounds "
                             f"for a table of {vocab} rows")
    return all_ids.remainder(vocab) if wrap else all_ids


class _GatherTable(torch.autograd.Function):
    """The whole (padded) table from the ranks' blocks; its backward hands
    each rank its block of the mean gradient."""

    @staticmethod
    def forward(ctx, block, coll):
        ctx.coll = coll
        return coll.all_gather(block.contiguous(), 0, TABLE_PURPOSE)

    @staticmethod
    def backward(ctx, grad):
        return ctx.coll.reduce_scatter(grad.contiguous(), 0, TABLE_PURPOSE), None


def _is_index(t) -> bool:
    return isinstance(t, torch.Tensor) and not (t.is_floating_point() or t.is_complex()
                                                or t.dtype == torch.bool)


class RowSplitTable:
    """A sparse table as the loss sees it when its rows are split over the
    data axis: this rank's ``block`` (rows ``rank x len(block)`` on of the
    zero-padded storage) of a table of ``vocab`` logical rows. Reports the
    table's logical shape; row reads run :class:`SparseRowLookup`, other
    uses the whole table (module docstring). ``dtype``: a cast the model
    asked for (``.to(dtype)``), applied to what a read returns. Without
    ``coll`` it only records its uses in ``uses``, as a table of ``world``
    blocks. ``gathered``: the ids gathered in this forward, by ids
    tensor, shared by the forward's tables."""

    def __init__(self, block: torch.Tensor, coll, vocab: int, rank: int,
                 dtype: Optional[torch.dtype] = None,
                 uses: Optional[List[Tuple]] = None, world: int = 1,
                 gathered: Optional[dict] = None):
        self.block = block
        self.coll = coll
        self.vocab = int(vocab)
        self.rank = int(rank)
        self.world = coll.size if coll is not None else int(world)
        self._dtype = dtype
        self.uses = uses if uses is not None else []
        self.gathered = gathered if gathered is not None else {}

    # -------------------------------------------------------- tensor facts
    @property
    def shape(self) -> torch.Size:
        return torch.Size((self.vocab,) + tuple(self.block.shape[1:]))

    def size(self, dim: Optional[int] = None):
        return self.shape if dim is None else self.shape[dim]

    def dim(self) -> int:
        return self.block.dim()

    ndim = property(dim)

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype or self.block.dtype

    @property
    def device(self) -> torch.device:
        return self.block.device

    def is_floating_point(self) -> bool:
        return self.dtype.is_floating_point

    def _cast(self, t: torch.Tensor) -> torch.Tensor:
        return t if self._dtype is None else t.to(self._dtype)

    # ---------------------------------------------------------------- reads
    def lookup(self, ids: torch.Tensor, wrap: bool = False) -> torch.Tensor:
        """The rows ``ids`` (any shape) of the table: ``ids.shape +
        row shape``. ``wrap``: a negative id counts from the end, as in
        ``table[ids]``."""
        row_shape = tuple(self.block.shape[1:])
        # Holding ids in the value keeps its id() from being reused.
        key = (id(ids), ids._version)
        first = key not in self.gathered
        if self.coll is None:
            self.gathered[key] = (ids, None)
            self.uses.append(("rows", ids.numel(), row_shape, self.block.dtype, first))
            return torch.empty(tuple(ids.shape) + row_shape, dtype=self.dtype, device="meta")
        if first:
            self.gathered[key] = (ids, self.coll.all_gather(
                ids.reshape(-1).to(torch.int32).contiguous(), 0, SPARSE_PURPOSE))
        all_ids = _checked(self.gathered[key][1], self.vocab, wrap)
        lo = self.rank * self.block.shape[0]
        rows = SparseRowLookup.apply(self.block, all_ids, self.coll, lo)
        return self._cast(rows.reshape(tuple(ids.shape) + row_shape))

    def full(self) -> torch.Tensor:
        """The whole table (logical rows), all-gathered with autograd."""
        if self.coll is None:
            n_rows = self.block.shape[0] * self.world
            self.uses.append(("table", (n_rows,) + tuple(self.block.shape[1:]),
                              self.block.dtype))
            return torch.empty(self.shape, dtype=self.dtype, device="meta")
        return self._cast(_GatherTable.apply(self.block, self.coll).narrow(0, 0, self.vocab))

    def __getitem__(self, index):
        if _is_index(index):
            return self.lookup(index, wrap=True)
        return self.full()[index]

    def index_select(self, dim: int, index: torch.Tensor) -> torch.Tensor:
        if dim == 0:
            return self.lookup(index)
        return self.full().index_select(dim, index)

    def to(self, *args, **kwargs):
        """A dtype-only cast stays a row-split table (reads are cast); any
        other ``to`` takes the whole table."""
        if len(args) == 1 and isinstance(args[0], torch.dtype) and not kwargs:
            return RowSplitTable(self.block, self.coll, self.vocab, self.rank,
                                 dtype=args[0], uses=self.uses, world=self.world,
                                 gathered=self.gathered)
        if not args and set(kwargs) == {"dtype"}:
            return self.to(kwargs["dtype"])
        return self.full().to(*args, **kwargs)

    def __getattr__(self, name):
        # Every other tensor attribute or method: the whole table's.
        if name.startswith("_") or name in ("block", "coll", "vocab", "rank", "uses",
                                            "world", "gathered"):
            raise AttributeError(name)
        return getattr(self.full(), name)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is F.embedding:
            ids = args[0] if args else kwargs.get("input")
            weight = args[1] if len(args) > 1 else kwargs.get("weight")
            rest = dict(zip(("padding_idx", "max_norm"), args[2:4]), **kwargs)
            if isinstance(weight, RowSplitTable) and rest.get("padding_idx") is None \
                    and rest.get("max_norm") is None and not isinstance(ids, RowSplitTable):
                return weight.lookup(ids)
        if func in (torch.index_select, torch.Tensor.index_select) and \
                isinstance(args[0], RowSplitTable) and len(args) >= 3 and args[1] == 0:
            return args[0].lookup(args[2])

        def whole(x):
            if isinstance(x, RowSplitTable):
                return x.full()
            if isinstance(x, (list, tuple)):
                return type(x)(whole(v) for v in x)
            return x

        return func(*whole(tuple(args)), **{k: whole(v) for k, v in kwargs.items()})

    # Python operators of a table used whole (the tied output projection).
    def __matmul__(self, other):
        return self.full() @ other

    def __rmatmul__(self, other):
        return other @ self.full()

    def __mul__(self, other):
        return self.full() * other

    __rmul__ = __mul__

    def __add__(self, other):
        return self.full() + other

    __radd__ = __add__

    def __sub__(self, other):
        return self.full() - other

    def __rsub__(self, other):
        return other - self.full()

    def __truediv__(self, other):
        return self.full() / other

    def __neg__(self):
        return -self.full()

    def __repr__(self) -> str:
        return (f"RowSplitTable(vocab={self.vocab}, block={tuple(self.block.shape)}, "
                f"rank={self.rank}, dtype={self.dtype})")


def predicted_bytes(uses: List[Tuple], n: int) -> dict:
    """``{purpose: {kind: bytes}}`` a step's forward and backward move for
    a row-split table's recorded uses on ``n`` ranks, in the units of
    ``Collectives.nbytes`` (an all-gather: the gathered bytes; a
    reduce-scatter: its input): per row read of ``T`` ids on a rank, the
    ids' all-gather (``4 n T``, the first read of those ids only), the
    rows' reduce-scatter and the gradient's all-gather (``n T x row
    bytes`` each); per whole-table use,
    the table's all-gather and its gradient's reduce-scatter (the padded
    storage's bytes each)."""
    out = {SPARSE_PURPOSE: {"all_gather": 0, "reduce_scatter": 0},
           TABLE_PURPOSE: {"all_gather": 0, "reduce_scatter": 0}}
    for use in uses:
        if use[0] == "rows":
            _, t, row_shape, dtype, gathers_ids = use
            row = int(torch.Size(row_shape).numel()) * dtype.itemsize
            out[SPARSE_PURPOSE]["all_gather"] += n * t * 4 * gathers_ids + n * t * row
            out[SPARSE_PURPOSE]["reduce_scatter"] += n * t * row
        else:
            _, shape, dtype = use
            b = int(torch.Size(shape).numel()) * dtype.itemsize
            out[TABLE_PURPOSE]["all_gather"] += b
            out[TABLE_PURPOSE]["reduce_scatter"] += b
    return out
