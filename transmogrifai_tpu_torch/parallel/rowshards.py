"""Row shards: the port's stand-in for GSPMD on a mesh's data axis.

The JAX package places a sweep's rows on the data axis of its mesh and
lets XLA insert a `psum` wherever a fit reduces over rows. Torch has no
such compiler, so the port reduces explicitly: a `RowShards` holds the
row ranges of one sweep row's devices, and every fit that runs on a data
axis (`models/trees.py`, `models/logistic.py`, `models/linear.py`, the
sweep's handlers in `parallel/sweep.py`) computes a partial on each shard
and adds the partials here.

- **One thread drives every shard of a lane.** Each shard's work is
  enqueued on its own device's current stream, so distinct cards overlap.
- **The lead is shard 0's device.** Reductions, the split search, the
  optimizers' steps and the metric run there.
- **Shards are contiguous row ranges, as even as n allows, and not
  padded.** This is a stated difference from the JAX package, which pads
  the rows to a multiple of the data width with zero-weight rows (GSPMD
  needs equal shards) and then has to keep quantile edges and bootstrap
  draws off the pad rows (its `_sweep_n_rows`). A zero-weight row adds
  exactly 0 to every sum, so the two groupings differ only in how the
  partials are grouped; with no pad, the edges and the forest draws here
  see the n real rows and nothing needs a row count of its own.
- **Reductions move the partials to the lead and add them in shard
  order**, ((p0 + p1) + p2) …, so a result is the same bits whatever the
  card and the thread timing.
- **Inputs go out once.** `broadcast` copies a tensor once to each
  distinct shard device; shards on a repeated device share one copy.

Every operation on a shard runs inside its device's context
(`torch.cuda.device`): a kernel launched for `cuda:1`'s tensors while
`cuda:0` is current would run on the wrong card's stream. One card, even
with a mesh that repeats it, cannot show that fault, so `on` is the only
way this module touches a shard's device.

The big path (`parallel/bigdata.py`, a builder given
``sharding=data_sharding(mesh)``) shards its resident matrices the same
way, with three rules of its own:

- **Shards are whole upload chunks** (`chunk_shards`): the builders pad
  the rows to a multiple of the upload chunk and every chunked function
  raises on a partial chunk (F2), so a shard boundary never falls inside
  a chunk. The chunks are spread as evenly as they go, the first shards
  one chunk more (4,456,448 rows in 17 chunks of 262,144 over two shards:
  9 + 8). Each chunk is written by K12 into the one shard that owns it,
  at its local row.
- **One copy stream per card.** The upload copies a chunk on a side
  stream of its shard's device, launches K12 in that device's context on
  that stream, and joins each distinct device's stream to that device's
  current stream once at the end; shards on a repeated card share its
  stream.
- **The leaf formula runs once, on the lead.** A tree grown over shards
  takes K3's leaf sums on each shard, adds them on the lead and applies
  the formula to the total (`models/trees.py`, `grow_trees`); the LR
  grid adds each product over rows on the lead and takes Σw and the
  penalty there once.

A matrix split so is a `RowSplit`: the shards and the parts. The
builders and the sweep return it, and every fit and predictor that takes
a matrix takes a tensor or a `RowSplit` in its place (`rows_of` unpacks
either; a tensor is the one-shard case, with the same bits as before).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence

import torch

__all__ = ["RowShards", "RowSplit", "chunk_shards", "rows_of"]


def _indexed(d) -> torch.device:
    """`d` as a device with its index (``cuda`` means the current card),
    so equal devices compare equal."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class RowShards:
    """The contiguous row ranges of `n` rows over `devices` (one shard per
    entry, repeats allowed): shard k holds rows bounds[k] .. bounds[k + 1]
    on devices[k], the first n % S shards one row more than the rest."""

    def __init__(self, n: int, devices: Sequence[torch.device]):
        self.devices: List[torch.device] = [_indexed(d) for d in devices]
        S = len(self.devices)
        if S < 1 or (S > 1 and n < S):
            raise ValueError(f"RowShards: {n} rows cannot fill {S} shards")
        base, extra = divmod(int(n), S)
        self.sizes = [base + (k < extra) for k in range(S)]
        self.bounds = [0]
        for size in self.sizes:
            self.bounds.append(self.bounds[-1] + size)
        self.n = int(n)
        self.lead = self.devices[0]

    @classmethod
    def of_sizes(cls, sizes: Sequence[int],
                 devices: Sequence[torch.device]) -> "RowShards":
        """Shards of the given row counts (in order) on `devices`."""
        if len(sizes) != len(devices) or min(sizes, default=0) < 0:
            raise ValueError(f"RowShards.of_sizes: sizes {list(sizes)} for "
                             f"{len(devices)} devices")
        out = cls(sum(sizes), devices)
        out.sizes = [int(s) for s in sizes]
        out.bounds = [0]
        for size in out.sizes:
            out.bounds.append(out.bounds[-1] + size)
        return out

    @classmethod
    def single(cls, t: torch.Tensor) -> "RowShards":
        """One shard holding every row of `t` on its device: the
        unsharded case of a fit written over shards."""
        return cls(t.shape[0], [t.device])

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return (f"RowShards(n={self.n}, sizes={self.sizes}, "
                f"devices={[str(d) for d in self.devices]})")

    def on(self, k: int):
        """Shard k's device context (a no-op on the CPU, and for a single
        shard, whose caller's tensors already pick their device)."""
        dev = self.devices[k]
        return (torch.cuda.device(dev)
                if dev.type == "cuda" and len(self.devices) > 1
                else contextlib.nullcontext())

    def map(self, fn: Callable, *per_shard: Sequence) -> List:
        """[fn(a[k], b[k], …) for each shard k], each call inside shard
        k's device context."""
        out = []
        for k in range(self.n_shards):
            with self.on(k):
                out.append(fn(*(a[k] for a in per_shard)))
        return out

    def split(self, t: torch.Tensor, dim: int = 0) -> List[torch.Tensor]:
        """Shard k's rows of `t` (rows along `dim`) on its device,
        contiguous (a view where it already is one on that device)."""
        if t.shape[dim] != self.n:
            raise ValueError(f"RowShards.split: {t.shape[dim]} rows along "
                             f"dim {dim}, expected {self.n}")
        out = []
        for k, dev in enumerate(self.devices):
            with self.on(k):
                out.append(t.narrow(dim, self.bounds[k], self.sizes[k])
                           .to(dev).contiguous())
        return out

    def gather(self, parts: Sequence[torch.Tensor],
               dim: int = 0) -> torch.Tensor:
        """The shards' parts concatenated in row order on the lead; of one
        shard, its part itself (no copy), so the one-shard case of a path
        written over shards has the bits of the unsharded one."""
        if len(parts) == 1:
            return parts[0].to(self.lead)
        with self.on(0):
            return torch.cat([p.to(self.lead) for p in parts], dim)

    def sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Σ_k parts[k] on the lead, added in shard order."""
        with self.on(0):
            acc = parts[0].to(self.lead)
            for p in parts[1:]:
                acc = acc + p.to(self.lead)
        return acc

    def any(self, parts: Sequence[torch.Tensor],
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The OR of 0/1 flag tensors on the lead; with `out` (a lead
        tensor, possibly a view), OR-ed into it in place."""
        with self.on(0):
            acc = out
            for p in parts:
                q = p.to(self.lead)
                acc = q.clone() if acc is None else acc.bitwise_or_(q)
        return acc

    def broadcast(self, t: torch.Tensor) -> List[torch.Tensor]:
        """`t` on every shard's device: one copy per distinct device (the
        lead's shards, and shards on a repeated device, share one)."""
        copies: Dict[torch.device, torch.Tensor] = {t.device: t}
        out = []
        for k, dev in enumerate(self.devices):
            if dev not in copies:
                with self.on(k):
                    copies[dev] = t.to(dev)
            out.append(copies[dev])
        return out


def chunk_shards(n_pad: int, chunk: int,
                 devices: Sequence[torch.device]) -> RowShards:
    """`n_pad` rows (a multiple of `chunk`) over `devices` in whole chunks,
    as even as the chunks allow, the first shards one chunk more. Raises
    when a shard would get no chunk: a split inside a chunk is refused."""
    S = len(devices)
    if chunk <= 0 or n_pad % chunk != 0:
        raise ValueError(f"chunk_shards: {n_pad} rows are not a multiple of "
                         f"the chunk {chunk}")
    n_chunks = n_pad // chunk
    if S > 1 and n_chunks < S:
        raise ValueError(
            f"chunk_shards: {n_chunks} chunks of {chunk} rows cannot give "
            f"{S} shards a whole chunk each; a shard boundary inside a "
            "chunk is refused (use fewer shards or a smaller chunk_rows)")
    base, extra = divmod(n_chunks, S)
    return RowShards.of_sizes([(base + (k < extra)) * chunk
                               for k in range(S)], devices)


class RowSplit:
    """A matrix split over row shards: the `RowShards` and its parts, one
    per shard on that shard's device. The sweep's split of its training
    matrix, and what a builder given a data sharding returns; the learners
    of either take it in place of a tensor."""

    def __init__(self, shards: RowShards, parts: List[torch.Tensor]):
        if [p.shape[0] for p in parts] != shards.sizes:
            raise ValueError(f"RowSplit: parts of {[p.shape[0] for p in parts]}"
                             f" rows for {shards!r}")
        self.shards = shards
        self.parts = list(parts)

    @property
    def shape(self) -> torch.Size:
        return torch.Size((self.shards.n,) + tuple(self.parts[0].shape[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        """The lead's device, where reductions and gathers land."""
        return self.shards.lead

    def __repr__(self) -> str:
        return (f"RowSplit({tuple(self.shape)}, {self.dtype}, "
                f"{self.shards!r})")

    def gather(self) -> torch.Tensor:
        """The whole matrix on the lead, in row order (tests and checks;
        the learners never gather it)."""
        return self.shards.gather(self.parts)

    def preds(self, fn: Callable[..., Sequence[Dict]],
              *per_shard) -> List[Dict]:
        """`fn(*args_k)` (one prediction dict per pair) on every shard k,
        each key's values gathered to the lead in row order."""
        parts = self.shards.map(fn, *per_shard)
        return [{k: self.shards.gather([p[q][k] for p in parts])
                 for k in parts[0][q]} for q in range(len(parts[0]))]


def rows_of(X, *whole: torch.Tensor, dim: int = -1) -> tuple:
    """(shards, X's parts, then each tensor of `whole` split with X's
    bounds along `dim`) of a `RowSplit` X, or of a tensor X as one shard.
    `whole` holds the tensors a fit takes whole on the lead: labels (n,)
    and row weights (n,) or (P, n) have their rows along the last dim."""
    if isinstance(X, RowSplit):
        shards, parts = X.shards, X.parts
    else:
        shards, parts = RowShards.single(X), [X]
    return (shards, parts) + tuple(shards.split(t, dim % t.dim())
                                   for t in whole)
