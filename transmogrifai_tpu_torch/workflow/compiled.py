"""CompiledScorer: the fitted DAG planned as host and device segments.

The port's counterpart of the JAX package's `workflow/compiled.py`. Per
batch:

- host phase: materialize the raw columns, run host stages, and call each
  device stage's `host_prepare` (strings → ids, hash counts); the device
  inputs stay host numpy until a device segment runs;
- device phase: consecutive device stages run back to back on tensors on
  the model's device. A device segment returns only what a later segment
  or a result feature reads.

A plan whose device stages form one trailing segment (the usual shape:
string work happens in `host_prepare`) is `fusable` and scores with one
device segment per call (`score_fused`). Plans where a host stage reads a
device output alternate segments through `__call__`.

`score_padded`, the serving path, runs each device segment as a CUDA graph
on a CUDA device: the port's counterpart of the JAX package's one fused
dispatch per batch. A segment is captured once per input signature (the
bucket's shapes), its host inputs packed into one pinned buffer and moved
by one host→device copy into the graph's static inputs, and then replayed.
A segment that cannot be captured raises and names its stage; nothing
falls back to eager dispatch. A replay adds the launches its capture
recorded to `cuda_build.LAUNCHES`.

Quantized inference (`quant=ScoringQuant("int8"|"int4")` or the
"-calibrated" variants) is the JAX package's wire: the request's float
leaves ship as per-feature affine uint8 (int4 packs two features per byte,
feature 2j in the low nibble), masks as exact uint8 0/1, quantized on the
host (`quantize_wire`, byte for byte the JAX package's) and dequantized on
the device by the K10 kernel (`csrc/wire_dequant.cu`, all leaves of a batch
in one launch) inside the segment; the fitted tables compute from narrowed
dtypes (`Transformer.narrow_device_constants`: f16 tree edges, int16 split
features, uint8 split bins, bf16 linear weights). Stated tolerance per
feature: scale/2 = (hi − lo)/(2·(2^bits − 1)) on the batch's own [lo, hi]
range (batch-relative) or the fit-time range (calibrated).

The fitted tables of each device stage (`device_constants(device)`) are
built on the device once, when the scorer is built.

Sharded scoring (`sharding=parallel.mesh.data_sharding(mesh)`, the JAX
package's row sharding): the host phase runs once per batch; each device
segment then runs once per row shard of the mesh's data axis
(`parallel/rowshards.py`, contiguous row ranges), on the shard's device,
with the stage constants built once per distinct device; a leaf whose
leading axis is the batch's rows is cut to the shard's rows and any other
leaf goes whole (the JAX rule, which matches on the row count). The
outputs are gathered in row order on the model's device. A batch whose
row count the shard count does not divide runs replicated on the
model's device, as the JAX package's placement leaves such a batch
replicated; `replicated_batches` counts those, `sharded_batches` the
rest. `score_padded` and the CUDA graphs stay unsharded.
"""

from __future__ import annotations

import ctypes
import logging
import time
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from transmogrifai_tpu_torch import cuda_build
from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.columns import Column, to_host
from transmogrifai_tpu_torch.data.dataset import Dataset
from transmogrifai_tpu_torch.features.dag import topological_layers
from transmogrifai_tpu_torch.obs.trace import TRACER, add_event
from transmogrifai_tpu_torch.parallel.mesh import replicated
from transmogrifai_tpu_torch.parallel.rowshards import RowShards
from transmogrifai_tpu_torch.stages.base import (
    HOST_KINDS, FeatureGeneratorStage, Transformer, compiled_scoring,
    fma_f32, is_host_stage, to_device)

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class ScoringQuant:
    """Quantized-inference mode: ``"int8"`` ships 1 byte per element on
    the wire, ``"int4"`` half that. ``calibrated`` quantizes against the
    fit-time per-feature ranges persisted with the model
    (``WorkflowModel.quant_calibration``), so a row's score does not
    depend on its batchmates; without it [lo, hi] is each batch's own
    range. A model with no captured calibration falls back to
    batch-relative ranges."""

    mode: str = "int8"
    calibrated: bool = False

    def __post_init__(self) -> None:
        if self.mode not in ("int8", "int4"):
            raise ValueError(
                f"quantized scoring mode must be 'int8' or 'int4', "
                f"got {self.mode!r}")

    @property
    def bits(self) -> int:
        return 4 if self.mode == "int4" else 8

    @staticmethod
    def resolve(q: Any) -> Optional["ScoringQuant"]:
        """None | "int8[-calibrated]" | "int4[-calibrated]" |
        ScoringQuant -> Optional[ScoringQuant]."""
        if q is None or isinstance(q, ScoringQuant):
            return q
        s = str(q)
        if s.endswith("-calibrated"):
            return ScoringQuant(s[:-len("-calibrated")], calibrated=True)
        return ScoringQuant(s)


# -- the quantized request wire, host half (numpy) -------------------------- #

def _pack4_np(q: np.ndarray) -> np.ndarray:
    """(n, d) uint8 in [0, 15] -> (n, ceil(d/2)) uint8: feature 2j in the
    low nibble, 2j + 1 in the high one."""
    n, d = q.shape
    if d % 2:
        q = np.concatenate([q, np.zeros((n, 1), np.uint8)], axis=1)
    return (q[:, 0::2] | (q[:, 1::2] << 4)).astype(np.uint8)


def quantize_leaf(arr: np.ndarray, bits: int,
                  lo: Optional[np.ndarray] = None,
                  hi: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """Per-feature affine uint8 of one (n,) or (n, d) float leaf. NaN
    quantizes to lo, values outside [lo, hi] clip to the bounds; the "q1"
    key marks a 1-D leaf. With `lo`/`hi` (calibrated ranges) the affine
    constants do not depend on the batch; without them [lo, hi] is the
    batch's own finite range."""
    a = np.asarray(arr, np.float32)
    one_d = a.ndim == 1
    if one_d:
        a = a[:, None]
    if lo is None or hi is None:
        with np.errstate(invalid="ignore"), warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            fin = np.where(np.isfinite(a), a, np.nan)
            lo = np.nanmin(fin, axis=0) if a.shape[0] \
                else np.zeros(a.shape[1])
            hi = np.nanmax(fin, axis=0) if a.shape[0] \
                else np.zeros(a.shape[1])
        lo = np.where(np.isfinite(lo), lo, 0.0).astype(np.float32)
        hi = np.where(np.isfinite(hi), hi, lo).astype(np.float32)
    else:
        lo = np.asarray(lo, np.float32).reshape(-1)
        hi = np.asarray(hi, np.float32).reshape(-1)
    qmax = float((1 << bits) - 1)
    scale = np.where(hi > lo, (hi - lo) / qmax, 1.0).astype(np.float32)
    q = np.rint((a - lo) / scale)
    q = np.where(np.isnan(q), 0.0, q)
    q = np.clip(q, 0.0, qmax).astype(np.uint8)
    if bits == 4:
        q = _pack4_np(q)
    return {("q1" if one_d else "q"): q, "scale": scale, "lo": lo}


_WIRE_KEYS = ({"q", "scale", "lo"}, {"q1", "scale", "lo"})


def quantize_wire(tree: Any, bits: int,
                  ranges: Optional[Dict[str, Any]] = None) -> Any:
    """The wire form of a host device-input pytree: float numpy leaves
    become affine uint8 wire dicts, "mask" leaves (exact 0/1) exact uint8,
    and tensors already on the device pass through. `ranges` maps a
    column uid (the tree's top-level keys) to its calibrated
    {"lo": [...], "hi": [...]}; a leaf whose entry has the leaf's width
    quantizes against it, others against the batch's own range."""
    def leaf_ranges(rng, width: int):
        if rng is None:
            return None, None
        lo = np.asarray(rng.get("lo"), np.float32).reshape(-1)
        hi = np.asarray(rng.get("hi"), np.float32).reshape(-1)
        if lo.shape[0] != width or hi.shape[0] != width:
            return None, None  # stale calibration: batch-relative leaf
        return lo, hi

    def walk(node, key=None, rng=None):
        if isinstance(node, dict):
            return {k: walk(v, k,
                            (ranges.get(k) if ranges is not None
                             and k in ranges else rng))
                    for k, v in node.items()}
        if isinstance(node, np.ndarray) and node.dtype.kind == "f":
            if key == "mask":
                return node.astype(np.uint8)
            if node.ndim in (1, 2):
                width = 1 if node.ndim == 1 else node.shape[1]
                lo, hi = leaf_ranges(rng, width)
                return quantize_leaf(node, bits, lo=lo, hi=hi)
        return node
    return walk(tree)


# -- the device half: K10 --------------------------------------------------- #

def _wire_parts(wire: Dict[str, torch.Tensor], bits: int):
    """(q, scale, lo, n, d, one_d) of a wire dict, checked."""
    one_d = "q1" in wire
    q = wire["q1"] if one_d else wire["q"]
    scale, lo = wire["scale"], wire["lo"]
    d = int(scale.shape[0])
    width = (d + 1) // 2 if bits == 4 else d
    if (q.dtype != torch.uint8 or q.dim() != 2 or q.shape[1] != width
            or scale.dtype != torch.float32 or lo.dtype != torch.float32
            or tuple(lo.shape) != (d,) or (one_d and d != 1)):
        raise ValueError(
            f"wire leaf: q {q.dtype} {tuple(q.shape)}, scale "
            f"{scale.dtype} {tuple(scale.shape)}, lo {lo.dtype} "
            f"{tuple(lo.shape)} do not form a {bits}-bit wire of width {d}")
    return q, scale, lo, int(q.shape[0]), d, one_d


def dequantize_leaf_plain(wire: Dict[str, torch.Tensor], bits: int
                          ) -> torch.Tensor:
    """The plain version of K10 for one leaf: x = q·scale + lo in f32 as
    one fused multiply-add (XLA's CPU program contracts the JAX package's
    `dequantize_leaf` into one), unpacking int4 nibbles first."""
    q, scale, lo, n, d, one_d = _wire_parts(wire, bits)
    if bits == 4:
        q = torch.stack([q & 0x0F, q >> 4], dim=-1).reshape(
            n, 2 * q.shape[1])[:, :d]
    x = fma_f32(q.to(torch.float32), scale.expand(n, d), lo.expand(n, d))
    return x[:, 0] if one_d else x


# the host table: 7 int64 a leaf (q, scale, lo, out, n·d, d, bits); its
# address, the leaf count, the stream
_DEQUANT_ARGS = cuda_build.register(
    "wire_dequant", "wire_dequant",
    (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p))
cuda_build.register("wire_dequant", "wire_dequant_max_leaves", ())
_DEQUANT_FIELDS = 7


class _DequantPlan:
    """What one wire signature (the jobs' kinds, shapes, dtypes and bits)
    fixes for K10, checked once: each job's output shape in the batch's one
    output buffer (every leaf's view at a multiple of 16 bytes, cut by one
    `split_with_sizes`), and the host table of the launches with its sizes
    filled in, whose address columns each call refills."""

    def __init__(self, jobs, bits: int, max_leaves: int):
        sizes, rows, self.shapes, self.pieces = [], [], [], []
        for j, (kind, x) in enumerate(jobs):
            if kind == "wire":
                q, scale, lo, n, d, one_d = _wire_parts(x, bits)
                shape, b = (n,) if one_d else (n, d), bits
            else:
                if x.dtype != torch.uint8:
                    raise ValueError(f"wire mask: {x.dtype}, expected uint8")
                shape, n, d, b = tuple(x.shape), int(x.numel()), 1, 8
            total = n * d
            if total > 0:
                rows.append((j, total, d, b, sum(sizes)))
            # the job's piece, then the padding to a multiple of 4 floats
            self.pieces.append(len(sizes))
            sizes += [total] + ([-total % 4] if total % 4 else [])
            # a view of a 1-D piece only where the shape is not (total,)
            self.shapes.append(None if shape == (total,) else shape)
        self.sizes = sizes
        self.size = sum(sizes)
        self.jobs = [r[0] for r in rows]  # the jobs with work, in order
        self.table = np.zeros((len(rows), _DEQUANT_FIELDS), np.int64)
        for i, (_, total, d, b, _) in enumerate(rows):
            self.table[i, 4:] = (total, d, b)
        self.offsets = np.array([r[4] for r in rows], np.int64) * 4
        self.chunks = [(s, min(len(rows), s + max_leaves))
                       for s in range(0, len(rows), max_leaves)]


_DEQUANT_PLANS: Dict[tuple, _DequantPlan] = {}


def _dequantize_cuda(jobs: List[Tuple[str, Any]], bits: int
                     ) -> List[torch.Tensor]:
    """K10: every job (("wire", dict) or ("mask", uint8 tensor)) of one
    batch dequantized by one launch (one per MAX_LEAVES jobs with work)
    into views of one output buffer. The jobs' signature picks a plan,
    checked when it was made; a call reads each leaf's shape, dtype,
    device, layout and address, and nothing else."""
    sig, ptrs = [], []
    keep = []  # contiguous copies, alive until the launch
    for kind, x in jobs:
        if kind == "wire":
            one_d = "q1" in x
            q = x["q1"] if one_d else x["q"]
            scale, lo = x["scale"], x["lo"]
            sig.append((q.shape, q.dtype, q.get_device(), scale.shape,
                        scale.dtype, scale.get_device(), lo.shape, lo.dtype,
                        lo.get_device(), one_d))
            if not (q.is_contiguous() and scale.is_contiguous()
                    and lo.is_contiguous()):
                q, scale, lo = q.contiguous(), scale.contiguous(), \
                    lo.contiguous()
                keep.append((q, scale, lo))
            ptrs += (q.data_ptr(), scale.data_ptr(), lo.data_ptr())
        else:
            sig.append((x.shape, x.dtype, x.get_device()))
            if not x.is_contiguous():
                x = x.contiguous()
                keep.append(x)
            ptrs += (x.data_ptr(), 0, 0)
    key = (bits, tuple(sig))
    plan = _DEQUANT_PLANS.get(key)
    if plan is None:
        devs = {s[2] for s in sig} | {s[5] for s in sig if len(s) > 3} \
            | {s[8] for s in sig if len(s) > 3}
        if len(devs) != 1:
            raise ValueError(f"wire leaves on several devices: {devs}")
        plan = _DequantPlan(jobs, bits, cuda_build.entry(
            "wire_dequant", "wire_dequant_max_leaves")())
        _DEQUANT_PLANS[key] = plan
    first = jobs[0][1]
    dev = (first["scale"] if jobs[0][0] == "wire" else first).device
    buf = torch.empty(plan.size, dtype=torch.float32, device=dev)
    parts = buf.split_with_sizes(plan.sizes)
    outs = [parts[i] if shape is None else parts[i].view(shape)
            for i, shape in zip(plan.pieces, plan.shapes)]
    if plan.jobs:
        table = plan.table.copy()
        table[:, :3] = np.array(ptrs, np.int64).reshape(-1, 3)[plan.jobs]
        table[:, 3] = buf.data_ptr() + plan.offsets
        fn = cuda_build.entry("wire_dequant", "wire_dequant")
        base = table.ctypes.data
        for s, e in plan.chunks:
            err = cuda_build.launch(
                dev.index, fn, base + s * _DEQUANT_FIELDS * 8, e - s)
            cuda_build.check("wire_dequant", err)
            cuda_build.count("wire_dequant")
    return outs


def dequantize_wire_plain(tree: Any, bits: int) -> Any:
    """The plain version of K10 over a wire tree (tensors on any device):
    wire dicts dequantize, uint8 leaves become f32 0/1, other leaves pass
    through."""
    if isinstance(tree, dict):
        if set(tree) in _WIRE_KEYS:
            return dequantize_leaf_plain(tree, bits)
        return {k: dequantize_wire_plain(v, bits) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.uint8:
        return tree.to(torch.float32)
    return tree


def _is_wire(node) -> bool:
    return len(node) == 3 and "scale" in node and "lo" in node \
        and ("q" in node or "q1" in node)


def dequantize_wire(tree: Any, bits: int) -> Any:
    """The inverse walk, on the device: wire dicts dequantize, uint8
    leaves (the masks) become the f32 0/1 contract, other tensors pass
    through. On CUDA every leaf of the tree goes through one K10 launch
    (or raises); on the CPU the tree takes the plain version."""
    jobs: List[Tuple[str, Any]] = []
    slots: List[Tuple[dict, Any]] = []  # where each job's output goes

    def walk(node: dict) -> dict:
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                if _is_wire(v):
                    jobs.append(("wire", v))
                    slots.append((out, k))
                else:
                    v = walk(v)
            elif isinstance(v, torch.Tensor) and v.dtype == torch.uint8:
                jobs.append(("mask", v))
                slots.append((out, k))
            out[k] = v
        return out

    root = {"": tree}
    shape = walk(root)
    if not jobs:
        return tree
    first = jobs[0][1]["scale"] if jobs[0][0] == "wire" else jobs[0][1]
    if first.device.type == "cpu":
        return dequantize_wire_plain(tree, bits)
    if first.device.type != "cuda":
        raise ValueError(f"dequantize_wire: unsupported device "
                         f"{first.device}")
    for (node, k), out in zip(slots, _dequantize_cuda(jobs, bits)):
        node[k] = out
    return shape[""]


# -- batch helpers ---------------------------------------------------------- #

def pad_dataset(dataset: Dataset, target_rows: int) -> Dataset:
    """Pad a Dataset to `target_rows` by repeating its last row, so pad
    rows take the same host-encode path as the valid rows (and never widen
    a batch-relative quantization range)."""
    n = len(dataset)
    if target_rows < n:
        raise ValueError(f"cannot pad {n} rows down to {target_rows}")
    if target_rows == n:
        return dataset
    if n == 0:
        raise ValueError("cannot pad an empty dataset (no row to repeat)")
    pad_idx = np.full(target_rows - n, n - 1, dtype=np.int64)
    return Dataset.concat([dataset, dataset.take(pad_idx)])


def slice_result_tree(value: Any, start: int, stop: int) -> Any:
    """Slice every leaf of a scoring result pytree to rows [start, stop).
    A leaf is batch-leading: an array or tensor (object arrays of text,
    token lists or maps too) or a python list or tuple of per-row values.
    Any other leaf cannot be cut per request and raises, where the JAX
    package's rule passes it through whole, so that each request of a
    coalesced batch would receive every row's (F10 in ROADMAP.md)."""
    if isinstance(value, dict):
        return {k: slice_result_tree(v, start, stop)
                for k, v in value.items()}
    if isinstance(value, (np.ndarray, torch.Tensor)) and value.ndim >= 1:
        return value[start:stop]
    if isinstance(value, (list, tuple)):
        return value[start:stop]
    raise TypeError(f"cannot slice a {type(value).__name__} result leaf "
                    "to the rows of one request")


def _map_leaves(fn, tree: Any) -> Any:
    """`fn` of every leaf of a dict / list / tuple pytree."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def _concat_trees(parts: List[Any], device) -> Any:
    """Row shards' output pytrees joined in row order on `device`: each
    leaf a batch-leading tensor (or a list of per-row values)."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: _concat_trees([p[k] for p in parts], device)
                for k in first}
    if isinstance(first, torch.Tensor) and first.ndim >= 1:
        return torch.cat([p.to(device) for p in parts])
    if isinstance(first, list):
        return [v for p in parts for v in p]
    raise TypeError(f"cannot gather a {type(first).__name__} output leaf "
                    "over row shards")


def _column_from_device(ftype: type, dev) -> Column:
    """Wrap a device pytree back into a host Column (segment boundary)."""
    if isinstance(dev, dict) and "prediction" in dev:
        return Column(T.Prediction, {k: to_host(v) for k, v in dev.items()})
    if isinstance(dev, dict) and "value" in dev:
        return Column(ftype, {
            "value": to_host(dev["value"]).astype(np.float64),
            "mask": to_host(dev["mask"]) > 0.5})
    return Column(T.OPVector, to_host(dev))


def _flatten(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k],
                                                            f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, f"{path}[{i}]")]
    return [(path, tree)]


def _tree_nbytes(tree: Any) -> int:
    """Bytes of the array leaves of a pytree (numpy arrays and tensors)."""
    total = 0
    for _, x in _flatten(tree):
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, np.ndarray):
            total += x.nbytes
    return total


def _unflatten(tree: Any, leaves: Dict[str, Any], path: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, f"{path}/{k}")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    return leaves.get(path, tree)


def _leaf_key(x: Any):
    if isinstance(x, np.ndarray):
        return ("host", x.shape, str(x.dtype))
    if isinstance(x, torch.Tensor):
        return ("device", tuple(x.shape), str(x.dtype))
    return ("value", repr(x))


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def _clone_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_tree(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


_ALIGN = 16


class _SegmentGraph:
    """One device segment captured as a CUDA graph for one input
    signature. Host leaves of the inputs are packed into one pinned
    buffer and land in the graph's static inputs by one host→device copy;
    device leaves (an earlier segment's outputs) are copied on the device.
    Each run returns copies of the static outputs."""

    def __init__(self, scorer: "CompiledScorer", seg_idx: int,
                 inputs: Any):
        device = scorer.device
        self.leaves = _flatten(inputs)
        self.offsets: Dict[str, int] = {}
        nbytes = 0
        for path, x in self.leaves:
            if isinstance(x, np.ndarray):
                if x.dtype == object:
                    raise TypeError(
                        f"device segment {seg_idx}: input {path} is an "
                        "object array and cannot ride to the device")
                self.offsets[path] = nbytes
                nbytes += -(-x.nbytes // _ALIGN) * _ALIGN
        self.pinned = torch.empty(max(nbytes, _ALIGN), dtype=torch.uint8,
                                  pin_memory=True)
        self.staging = torch.empty(max(nbytes, _ALIGN), dtype=torch.uint8,
                                   device=device)
        self.copied = torch.cuda.Event()
        static: Dict[str, Any] = {}
        for path, x in self.leaves:
            if isinstance(x, np.ndarray):
                off = self.offsets[path]
                static[path] = self.staging[off:off + x.nbytes].view(
                    _torch_dtype(x.dtype)).view(x.shape)
            elif isinstance(x, torch.Tensor):
                static[path] = torch.empty_like(x, device=device)
        self.static = _unflatten(inputs, static)
        self._static_leaves = static
        self.load(self.leaves)
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):  # warm up (lazy inits) off capture
            scorer._run_segment(seg_idx, *self.static)
        current.wait_stream(side)
        before = cuda_build.launches_snapshot()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph):
                self.out = scorer._run_segment(seg_idx, *self.static)
        except Exception as e:
            stage = scorer._current_stage
            where = ("" if stage is None else
                     f" at stage {stage.operation_name} ({stage.uid})")
            raise RuntimeError(
                f"CUDA graph capture of device segment {seg_idx} "
                f"[{scorer.segment_ops(seg_idx)}] failed{where}: "
                f"{type(e).__name__}: {e}") from e
        finally:
            after = cuda_build.launches_snapshot()
            cuda_build.set_launches(before)
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}

    def load(self, leaves: List[Tuple[str, Any]]) -> None:
        """Copy this call's input leaves (`_flatten` of inputs of the
        captured signature) into the static inputs: host leaves through
        the pinned buffer (one host→device copy), device leaves on the
        device."""
        self.copied.synchronize()  # the last copy out of `pinned` is done
        host = self.pinned.numpy()
        for path, x in leaves:
            if isinstance(x, np.ndarray):
                off = self.offsets[path]
                host[off:off + x.nbytes] = np.ascontiguousarray(x).view(
                    np.uint8).reshape(-1)
            elif isinstance(x, torch.Tensor):
                self._static_leaves[path].copy_(x)
        if self.offsets:
            self.staging.copy_(self.pinned, non_blocking=True)
            self.copied.record()

    def run(self, leaves: List[Tuple[str, Any]]) -> Any:
        self.load(leaves)
        self.graph.replay()
        cuda_build.add_launches(self.launches)
        return _clone_tree(self.out)


class CompiledScorer:
    """The planned scorer of a fitted model. `quant` selects quantized
    inference (module docstring); `graphs` runs `score_padded`'s device
    segments as CUDA graphs (default: on a CUDA device)."""

    def __init__(self, model, quant: Any = None,
                 graphs: Optional[bool] = None, sharding=None):
        self.model = model
        self.device = model.device
        self.quant = ScoringQuant.resolve(quant)
        self.sharding = sharding
        self._shard_devices = (sharding.data_devices
                               if sharding is not None else [self.device])
        if graphs is None:
            graphs = self.device.type == "cuda" and sharding is None
        if graphs and self.device.type != "cuda":
            raise ValueError("CUDA graphs need a CUDA device, the model "
                             f"scores on {self.device}")
        if graphs and sharding is not None:
            raise ValueError("sharded scoring runs its segments eagerly; "
                             "the CUDA graphs serve unsharded batches")
        self.graphs = graphs
        self.sharded_batches = 0
        self.replicated_batches = 0
        self._graph_cache: Dict[Tuple, _SegmentGraph] = {}
        self._current_stage: Optional[Transformer] = None
        self._cal_ranges: Optional[Dict[str, Any]] = None
        if self.quant is not None and self.quant.calibrated:
            cal = getattr(model, "quant_calibration", None)
            if cal:
                self._cal_ranges = dict(cal)
            else:
                log.warning(
                    "calibrated quantization requested but the model "
                    "carries no quant_calibration; falling back to "
                    "batch-relative ranges")
        layers = topological_layers(model.result_features)
        self.generators: List[FeatureGeneratorStage] = (
            list(layers[0]) if layers else [])
        ordered: List[Transformer] = []
        for layer in layers[1:]:
            for stage in layer:
                fitted = model.fitted.get(stage.uid)
                if fitted is None:
                    raise RuntimeError(f"Unfitted stage {stage.uid}")
                ordered.append(fitted)
        self._stage_out_uid = {s.uid: s.get_output().uid for s in ordered}
        # alternating host/device segments in topological order
        self.segments: List[Tuple[str, List[Transformer]]] = []
        for s in ordered:
            kind = "host" if is_host_stage(s) else "device"
            if not self.segments or self.segments[-1][0] != kind:
                self.segments.append((kind, []))
            self.segments[-1][1].append(s)
        # per segment, the outputs a later segment or a result reads
        result_uids = {f.uid for f in model.result_features}
        self._seg_out_uids: List[List[str]] = []
        for i, (kind, stages) in enumerate(self.segments):
            produced = {self._stage_out_uid[s.uid] for s in stages}
            needed = set(result_uids)
            for _, later in self.segments[i + 1:]:
                for s2 in later:
                    needed.update(f.uid for f in s2.input_features)
            self._seg_out_uids.append(sorted(produced & needed))
        self.device_stages: List[Transformer] = [
            s for kind, stages in self.segments if kind == "device"
            for s in stages]
        self._consts: Dict[str, Any] = self._build_consts(self.device)
        self._consts_by_device = {self.device: self._consts}

    def _build_consts(self, device) -> Dict[str, Any]:
        """Every device stage's fitted tables on `device` (narrowed in
        quantized mode)."""
        out: Dict[str, Any] = {}
        for s in self.device_stages:
            c = s.device_constants(device)
            if c is not None:
                out[s.uid] = (s.narrow_device_constants(c)
                              if self.quant else c)
        return out

    def _consts_on(self, device) -> Dict[str, Any]:
        """The stage constants on `device`, built once per device."""
        got = self._consts_by_device.get(device)
        if got is None:
            got = self._consts_by_device[device] = self._build_consts(device)
        return got

    def segment_ops(self, seg_idx: int) -> str:
        return ",".join(s.operation_name for s in self.segments[seg_idx][1])

    # ------------------------------------------------------------------ #

    def _row_shards(self, n_rows: int):
        """The batch's row shards over the sharding's data axis, or None
        (no sharding, one shard, or a row count the shard count does not
        divide: then the batch runs replicated, and is counted)."""
        S = len(self._shard_devices)
        if self.sharding is None or S <= 1:
            return None
        placement = (self.sharding if n_rows % S == 0
                     else replicated(self.sharding.mesh))
        if not placement.spec:  # whole, on the model's device
            self.replicated_batches += 1
            return None
        self.sharded_batches += 1
        return RowShards(n_rows, placement.data_devices)

    def _run_sharded(self, seg_idx: int, encs: Dict[str, Any],
                     vals: Dict[str, Any], shards) -> Dict[str, Any]:
        """Device segment `seg_idx` once per row shard (batch-leading
        leaves cut to the shard's rows, the rest whole), each on its
        device with that device's constants; the outputs gathered in row
        order on the model's device."""
        outs = []
        for k, dev in enumerate(shards.devices):
            lo, hi = shards.bounds[k], shards.bounds[k + 1]

            def cut(leaf):
                if (isinstance(leaf, (np.ndarray, torch.Tensor))
                        and leaf.ndim >= 1 and leaf.shape[0] == shards.n):
                    leaf = leaf[lo:hi]
                return to_device(leaf, dev)
            with shards.on(k):
                outs.append(self._run_segment(
                    seg_idx, _map_leaves(cut, encs), _map_leaves(cut, vals),
                    self._consts_on(dev)))
        return _concat_trees(outs, self.device)

    def _run_segment(self, seg_idx: int, encs: Dict[str, Any],
                     dev_vals: Dict[str, Any],
                     consts_by_stage: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
        """Run one device segment's stages on device tensors (the wire form
        in quantized mode, dequantized first by K10); returns the
        segment's needed outputs by feature uid."""
        if consts_by_stage is None:
            consts_by_stage = self._consts
        if self.quant is not None:
            dev_vals = dequantize_wire(dev_vals, self.quant.bits)
        vals = dict(dev_vals)
        with compiled_scoring():
            for stage in self.segments[seg_idx][1]:
                self._current_stage = stage
                dev_inputs = [vals.get(f.uid) for f in stage.input_features]
                consts = consts_by_stage.get(stage.uid)
                if consts is not None:
                    out = stage.device_apply_with(
                        consts, encs.get(stage.uid), dev_inputs)
                else:
                    out = stage.device_apply(encs.get(stage.uid),
                                             dev_inputs)
                vals[self._stage_out_uid[stage.uid]] = out
        self._current_stage = None
        return {u: vals[u] for u in self._seg_out_uids[seg_idx]}

    def _dispatch(self, seg_idx: int, encs: Dict[str, Any],
                  vals: Dict[str, Any], graphs: bool,
                  shards=None) -> Dict[str, Any]:
        """Run device segment `seg_idx` on its inputs (host numpy leaves
        and device tensors): as the CUDA graph of these inputs' signature
        when `graphs` (captured at the first call), else eagerly, over the
        batch's row shards when it has them. Inside a trace span each
        dispatch adds a ``device_dispatch`` event with the bytes in and
        out and the host seconds to enqueue it, as the JAX package's
        scorer does (goodput's `scoring` section)."""
        t0 = time.perf_counter()
        if shards is not None:
            out = self._run_sharded(seg_idx, encs, vals, shards)
        elif not graphs:
            out = self._run_segment(seg_idx, to_device(encs, self.device),
                                    to_device(vals, self.device))
        else:
            leaves = _flatten((encs, vals))
            key = (seg_idx, tuple((p, _leaf_key(x)) for p, x in leaves))
            with torch.cuda.device(self.device):
                g = self._graph_cache.get(key)
                if g is None:
                    g = _SegmentGraph(self, seg_idx, (encs, vals))
                    self._graph_cache[key] = g
                out = g.run(leaves)
        if TRACER.current() is not None:
            add_event("device_dispatch", segment=self.segment_ops(seg_idx),
                      bytes_in=_tree_nbytes((encs, vals)),
                      bytes_out=_tree_nbytes(out),
                      dispatch_s=round(time.perf_counter() - t0, 6),
                      quant=self.quant.mode if self.quant else None)
        return out

    def _fused_index(self) -> int:
        """Index of the single trailing device segment, or raise."""
        dev_segs = [i for i, (k, _) in enumerate(self.segments)
                    if k == "device"]
        if len(dev_segs) != 1 or dev_segs[0] != len(self.segments) - 1:
            raise RuntimeError(
                "pipeline does not plan to a single trailing device "
                "segment; use __call__")
        return dev_segs[0]

    @property
    def fusable(self) -> bool:
        """True when the plan is a host prefix plus ONE trailing device
        segment (`score_fused` then runs one device segment per call)."""
        try:
            self._fused_index()
        except RuntimeError:
            return False
        return True

    def host_phase(self, dataset: Dataset):
        """Raw materialization + host-prefix stages + `host_prepare`:
        (encs, raw, columns), the device inputs as host numpy (the wire
        form in quantized mode)."""
        columns: Dict[str, Column] = {}
        for gen in self.generators:
            columns[gen.get_output().uid] = gen.materialize(
                dataset, allow_missing_response=True)
        for kind, stages in self.segments[:-1]:  # host prefix
            if kind != "host":
                raise RuntimeError("host_phase requires a host-prefix plan")
            for stage in stages:
                inputs = [columns[f.uid] for f in stage.input_features]
                columns[self._stage_out_uid[stage.uid]] = stage.transform(
                    inputs, self.device)
        encs: Dict[str, Any] = {}
        for stage in self.device_stages:
            enc = stage.host_prepare(
                [columns.get(f.uid) for f in stage.input_features])
            if enc is not None:
                encs[stage.uid] = enc
        raw: Dict[str, Any] = {}
        for uid, c in columns.items():
            if c.kind not in HOST_KINDS:
                hv = c.host_value()
                if hv is not None:
                    raw[uid] = hv
        if self.quant is not None:
            raw = quantize_wire(raw, self.quant.bits, ranges=self._cal_ranges)
        return encs, raw, columns

    # ------------------------------------------------------------------ #

    def run(self, dataset: Dataset, graphs: bool = False):
        """Execute all segments; returns (vals, columns): device values by
        feature uid (host numpy for columns no device segment produced)
        and the host columns."""
        columns: Dict[str, Column] = {}
        vals: Dict[str, Any] = {}
        shards = self._row_shards(len(dataset))
        for gen in self.generators:
            f = gen.get_output()
            c = gen.materialize(dataset, allow_missing_response=True)
            columns[f.uid] = c
            if c.kind not in HOST_KINDS:
                vals[f.uid] = c.host_value()
        for seg_idx, (kind, stages) in enumerate(self.segments):
            if kind == "host":
                for stage in stages:
                    inputs = []
                    for f in stage.input_features:
                        c = columns.get(f.uid)
                        if c is None:  # device-produced → materialize once
                            c = _column_from_device(f.ftype, vals[f.uid])
                            columns[f.uid] = c
                        inputs.append(c)
                    out_col = stage.transform(inputs, self.device)
                    uid = self._stage_out_uid[stage.uid]
                    columns[uid] = out_col
                    hv = out_col.host_value()
                    if hv is not None:
                        vals[uid] = hv
            else:
                encs: Dict[str, Any] = {}
                for stage in stages:
                    enc = stage.host_prepare(
                        [columns.get(f.uid) for f in stage.input_features])
                    if enc is not None:
                        encs[stage.uid] = enc
                args = vals
                if self.quant is not None:
                    # the still-host leaves go on the wire; device values
                    # of earlier segments pass through
                    args = quantize_wire(vals, self.quant.bits,
                                         ranges=self._cal_ranges)
                vals.update(self._dispatch(seg_idx, encs, args, graphs,
                                           shards))
        return vals, columns

    def __call__(self, dataset: Dataset, graphs: bool = False
                 ) -> Dict[str, Any]:
        vals, columns = self.run(dataset, graphs)
        result: Dict[str, Any] = {}
        for f in self.model.result_features:
            if f.uid in vals:
                result[f.name] = to_device(vals[f.uid], self.device)
            else:  # host-kind result feature
                result[f.name] = columns[f.uid].data
        return result

    def score_fused(self, dataset: Dataset, graphs: bool = False
                    ) -> Dict[str, Any]:
        """Host phase, then the single trailing device segment; returns
        the result features. Raises RuntimeError on plans with more than
        one device segment (`__call__` is the general path)."""
        fi = self._fused_index()
        shards = self._row_shards(len(dataset))
        encs, raw, columns = self.host_phase(dataset)
        out = self._dispatch(fi, encs, raw, graphs, shards)
        result: Dict[str, Any] = {}
        for f in self.model.result_features:
            if f.uid in out:
                result[f.name] = out[f.uid]
            else:
                # raw or host-prefix result features: their original
                # (unquantized) values
                hv = columns[f.uid].host_value()
                result[f.name] = (to_device(hv, self.device)
                                  if hv is not None else columns[f.uid].data)
        return result

    def score_padded(self, dataset: Dataset,
                     pad_to: int) -> Dict[str, Any]:
        """Score `dataset` padded up to `pad_to` rows (a bucket of the
        serving ladder) and return the valid rows only. On a CUDA device
        each device segment runs as the CUDA graph of its bucket
        (`graphs`)."""
        if self.sharding is not None:
            raise ValueError("score_padded serves unsharded batches; build "
                             "the service's scorer without a sharding")
        n_valid = len(dataset)
        padded = pad_dataset(dataset, pad_to)
        out = (self.score_fused(padded, self.graphs) if self.fusable
               else self(padded, self.graphs))
        if pad_to == n_valid:
            return out
        return {name: slice_result_tree(v, 0, n_valid)
                for name, v in out.items()}
