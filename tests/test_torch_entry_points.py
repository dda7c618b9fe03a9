"""Every C entry point of the port's CUDA sources against the ctypes
argument types its wrapper registers (`cuda_build.ARGTYPES`), on the CPU.

ctypes converts an argument by its declared type: a pointer or stream
that is left out of `argtypes`, or declared as an int, goes as a 32-bit C
int and is cut. So each entry point of every source of
`cuda_build.SOURCES` must be registered, with one ctypes type a C
parameter in the C order: `c_void_p` for a pointer (the stream too),
`c_int` for `int`, `c_int64` for `int64_t`, `c_float` for `float`.
Tolerance: equal.
"""

import ctypes
import re

import pytest

from transmogrifai_tpu_torch import cuda_build
# the modules that register the wrappers' entry points
from transmogrifai_tpu_torch.automl import sanity_checker  # noqa: F401
from transmogrifai_tpu_torch.evaluators import device_metrics  # noqa: F401
from transmogrifai_tpu_torch.models import trees  # noqa: F401
from transmogrifai_tpu_torch.parallel import bigdata  # noqa: F401
from transmogrifai_tpu_torch.workflow import compiled  # noqa: F401

_C_TYPES = {"int": ctypes.c_int, "int64_t": ctypes.c_int64,
            "float": ctypes.c_float}


def _c_entries():
    """[(source, function, [ctypes type a parameter])] of every
    `extern "C"` function of every source."""
    out = []
    for name in cuda_build.SOURCES:
        text = (cuda_build.SRC_DIR / f"{name}.cu").read_text()
        for fn, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', text):
            types = []
            for p in (q.strip() for q in params.split(",")):
                if not p:
                    continue
                if "*" in p:
                    types.append(ctypes.c_void_p)
                else:
                    types.append(_C_TYPES[p.rsplit(None, 1)[0]])
            out.append((name, fn, types))
    return out


C_ENTRIES = _c_entries()


def test_every_source_has_entry_points():
    assert {name for name, _, _ in C_ENTRIES} == set(cuda_build.SOURCES)


@pytest.mark.parametrize("name,fn,types", C_ENTRIES,
                         ids=[f"{n}:{f}" for n, f, _ in C_ENTRIES])
def test_ctypes_argtypes_name_every_c_parameter(name, fn, types):
    assert (name, fn) in cuda_build.ARGTYPES, f"{name}.cu:{fn} unregistered"
    assert list(cuda_build.ARGTYPES[(name, fn)]) == types


def test_every_registered_entry_point_exists():
    found = {(name, fn) for name, fn, _ in C_ENTRIES}
    assert set(cuda_build.ARGTYPES) <= found


def test_library_name_follows_the_headers_a_source_includes(tmp_path,
                                                            monkeypatch):
    """K4 and K12 share csrc/edge_count.cuh: an edit of the header gives
    both libraries a new name (so each builds anew), and none of the
    sources that do not include it."""
    for f in cuda_build.SRC_DIR.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(cuda_build, "SRC_DIR", tmp_path)
    before = {n: cuda_build.library_path(n) for n in cuda_build.SOURCES}
    header = tmp_path / "edge_count.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    moved = {n for n in cuda_build.SOURCES
             if cuda_build.library_path(n) != before[n]}
    assert moved == {"bin_features", "write_rows"}
