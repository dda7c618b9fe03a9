"""Device mesh helpers: the sweep × data grid over the GPUs of one host.

The port's counterpart of the JAX package's `parallel/mesh.py`. The JAX
package builds a `jax.sharding.Mesh` and lets XLA place the work; the
port keeps a small named-axes grid of `torch.device`s and places the work
itself:

- the ``"sweep"`` axis: independent (config, fold) fits spread across
  devices — K11's `_run_block` (`parallel/sweep.py`) runs one slice of a
  block per lane, and the scheduler (`parallel/scheduler.py`) one worker
  per lane;
- the ``"data"`` axis: rows of the training matrix split across the
  devices of a sweep row (`parallel/rowshards.py`), every reduction over
  rows an explicit sum of per-shard partials on the row's first device;
  `data_sharding(mesh)` places a scored batch's rows the same way.

`make_mesh` on CUDA takes distinct cards (``cuda:0 … cuda:n-1``) and
refuses more than `torch.cuda.device_count()`. On the CPU a mesh repeats
the one ``cpu`` device: the counterpart of the JAX tests' virtual CPU
devices, so lanes (threads) and data shards run and are tested here. A
test or the card script that wants data shards on one card builds the
mesh itself, repeating the card: ``Mesh(np.array([[cuda0, cuda0]],
dtype=object))``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from transmogrifai_tpu_torch.device import DeviceLike, resolve_device

__all__ = ["SWEEP_AXIS", "DATA_AXIS", "Mesh", "NamedSharding",
           "make_mesh", "make_multislice_mesh", "sweep_sharding",
           "data_sharding", "replicated"]

SWEEP_AXIS = "sweep"
DATA_AXIS = "data"


class Mesh:
    """A named-axes grid of `torch.device`s: `devices` is an object array
    of the axes' sizes, `shape` maps each axis name to its size."""

    def __init__(self, devices, axis_names: Sequence[str] = (SWEEP_AXIS,
                                                             DATA_AXIS)):
        grid = np.vectorize(torch.device, otypes=[object])(
            np.asarray(devices, dtype=object))
        if grid.ndim != len(axis_names):
            raise ValueError(f"{grid.ndim}-D devices for axes "
                             f"{tuple(axis_names)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, grid.shape))

    def rows(self) -> List[List[torch.device]]:
        """The devices of each row of the sweep axis (a row's data axis)."""
        rows = self.devices
        if SWEEP_AXIS in self.axis_names:
            rows = np.moveaxis(rows, self.axis_names.index(SWEEP_AXIS), 0)
        return [list(r) for r in rows.reshape(rows.shape[0], -1)]

    def lane_devices(self, k: int) -> List[torch.device]:
        """Sweep row k's devices: lane k's data shards, its lead first."""
        return self.rows()[k]

    def lanes(self) -> List[torch.device]:
        """Each sweep row's lead device (its first data shard)."""
        return [r[0] for r in self.rows()]

    @property
    def data_width(self) -> int:
        return self.shape.get(DATA_AXIS, 1)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


@dataclass(frozen=True)
class NamedSharding:
    """A leading axis placed over `spec`'s mesh axis (empty `spec`:
    replicated): a block's config axis over the sweep axis
    (`sweep_sharding`), or a scored batch's rows over the data axis
    (`data_sharding`)."""

    mesh: Mesh
    spec: Tuple[str, ...] = ()

    @property
    def n_shards(self) -> int:
        return self.mesh.shape[self.spec[0]] if self.spec else 1

    @property
    def rows(self) -> List[List[torch.device]]:
        """The sweep rows a block's lanes run on (one when replicated)."""
        rows = self.mesh.rows()
        return rows if self.spec == (SWEEP_AXIS,) else rows[:1]

    @property
    def lanes(self) -> List[torch.device]:
        return [r[0] for r in self.rows]

    @property
    def data_devices(self) -> List[torch.device]:
        """The devices a row-sharded batch is split over: the first sweep
        row's data axis (the rows are replicated over the sweep axis)."""
        row = self.mesh.lane_devices(0)
        return row if self.spec == (DATA_AXIS,) else row[:1]


def _devices(n: Optional[int], device: DeviceLike) -> List[torch.device]:
    dev = resolve_device(device)
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        n = have if n is None else n
        if n > have:
            raise ValueError(f"Requested {n} devices, have {have}")
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cpu")] * (1 if n is None else n)


def make_mesh(n_devices: Optional[int] = None,
              sweep: Optional[int] = None,
              axis_names: Tuple[str, str] = (SWEEP_AXIS, DATA_AXIS),
              device: DeviceLike = "cuda") -> Mesh:
    """A 2-D (sweep, data) mesh over the first `n_devices` devices of
    `device`'s kind (every card by default; one lane on the CPU, unless
    `n_devices` asks for more). `sweep` fixes the sweep-axis size (default:
    every device on sweep, data 1)."""
    devices = _devices(n_devices, device)
    n = len(devices)
    s = sweep if sweep is not None else n
    if s < 1 or n % s != 0:
        raise ValueError(f"sweep={s} must divide n_devices={n}")
    return Mesh(np.array(devices, dtype=object).reshape(s, n // s),
                axis_names)


def make_multislice_mesh(n_slices: int,
                         devices_per_slice: Optional[int] = None,
                         data_per_slice: Optional[int] = None,
                         device: DeviceLike = "cuda") -> Mesh:
    """(sweep, data) mesh laid out in `n_slices` contiguous groups of
    devices, slice-major on the sweep axis (the JAX package's fallback
    layout; torch exposes no slice topology). `data_per_slice` splits a
    slice's devices into a data axis (default: all of a slice's devices
    on data)."""
    if n_slices < 1:
        raise ValueError(f"n_slices={n_slices} must be >= 1")
    devices = _devices(None if devices_per_slice is None
                       else n_slices * devices_per_slice, device)
    if devices_per_slice is None:
        if len(devices) % n_slices != 0:
            raise ValueError(
                f"{len(devices)} devices do not divide into {n_slices} "
                f"equal contiguous slices ({len(devices)} % {n_slices} = "
                f"{len(devices) % n_slices}); pass devices_per_slice "
                "explicitly to use a subset")
        per = len(devices) // n_slices
    else:
        per = devices_per_slice
    if per < 1 or per * n_slices > len(devices):
        raise ValueError(
            f"need {max(per, 1) * n_slices} devices for {n_slices} "
            f"slices × {max(per, 1)}, have {len(devices)}")
    dps = data_per_slice or per
    if per % dps != 0:
        raise ValueError(f"data_per_slice={dps} must divide {per}")
    rows = []
    for i in range(n_slices):
        g = devices[i * per:(i + 1) * per]
        for s in range(per // dps):
            rows.append(g[s * dps:(s + 1) * dps])
    return Mesh(np.array(rows, dtype=object).reshape(len(rows), dps),
                (SWEEP_AXIS, DATA_AXIS))


def sweep_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (config) axis of a block over the sweep axis."""
    return NamedSharding(mesh, (SWEEP_AXIS,))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (row) axis of a scored batch over the data axis
    (`WorkflowModel.score_compiled(dataset, sharding=)`)."""
    return NamedSharding(mesh, (DATA_AXIS,))


def replicated(mesh: Mesh) -> NamedSharding:
    """The leading axis whole on the mesh's first device: one lane for a
    block, one shard for a scored batch."""
    return NamedSharding(mesh, ())
