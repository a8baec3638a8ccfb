"""ctypes binding for the native C++ SAH builder (bvh/cpp/builder.cpp).

Compiled on first use with g++ -O3 -fopenmp (no pybind11 in this
environment — plain C ABI + ctypes). Falls back cleanly when no compiler is
available; `available()` reports the state. Used for both the fine BVH
("jax" backend) and triangle clustering ("clustered" backend), where it
replaces the vectorized-NumPy builders at ~20-100x their speed on large
scenes — the same role the reference's SSE/OpenMP builder plays (bvh.cpp).
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_SRC = Path(__file__).parent / "cpp" / "builder.cpp"
_LIB_DIR = Path(tempfile.gettempdir()) / "uvtrace_native"


@functools.lru_cache(maxsize=1)
def _load():
    _LIB_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = _LIB_DIR / "libuvtrace_builder.so"
    if not lib_path.exists() or _SRC.stat().st_mtime > lib_path.stat().st_mtime:
        cmd = [
            "g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
            "-std=c++17", str(_SRC), "-o", str(lib_path),
        ]
        subprocess.run(cmd, check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.uvtrace_build.restype = ctypes.c_int32
    lib.uvtrace_build.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except (subprocess.CalledProcessError, OSError, FileNotFoundError):
        return False


def _run(tris: np.ndarray, max_leaf: int, mode: int):
    lib = _load()
    tris = np.ascontiguousarray(tris, np.float32)
    t = tris.shape[0]
    cap = 2 * t
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    left_first = np.empty(cap, np.int32)
    tri_count = np.empty(cap, np.int32)
    tri_idx = np.empty(t, np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    n = lib.uvtrace_build(
        tris.ctypes.data_as(fp), t, max_leaf, mode,
        node_min.ctypes.data_as(fp), node_max.ctypes.data_as(fp),
        left_first.ctypes.data_as(ip), tri_count.ctypes.data_as(ip),
        tri_idx.ctypes.data_as(ip),
    )
    if n < 0:
        raise RuntimeError("native builder failed")
    return node_min[:n], node_max[:n], left_first[:n], tri_count[:n], tri_idx


def build_bvh_native(tris: np.ndarray, max_leaf_size: int | None = None):
    """Native counterpart of bvh.builder.build_bvh -> FlatBVH."""
    from uvtrace.bvh.types import FlatBVH

    tris = np.ascontiguousarray(tris, np.float32)
    nm, nx, lf, tc, ti = _run(tris, max_leaf_size or 0, mode=0)
    return FlatBVH(
        node_min=nm, node_max=nx, left_first=lf, tri_count=tc,
        tri_idx=ti, sorted_tris=tris[ti],
    )


def build_clusters_native(tris: np.ndarray, cluster_size: int = 128):
    """Native counterpart of ops.cluster.build_clusters -> ClusteredScene."""
    from uvtrace.ops.cluster import ClusteredScene

    tris = np.ascontiguousarray(tris, np.float32)
    nm, nx, lf, tc, ti = _run(tris, cluster_size, mode=1)
    leaves = np.nonzero(tc > 0)[0]
    l_count = len(leaves)
    out_tris = np.zeros((l_count, cluster_size, 3, 3), np.float32)
    out_idx = np.full((l_count, cluster_size), -1, np.int32)
    box_min = np.empty((l_count, 3), np.float32)
    box_max = np.empty((l_count, 3), np.float32)
    for i, node in enumerate(leaves):
        start, cnt = lf[node], tc[node]
        ids = ti[start : start + cnt]
        out_tris[i, :cnt] = tris[ids]
        out_idx[i, :cnt] = ids
        box_min[i] = nm[node]
        box_max[i] = nx[node]
    return ClusteredScene(tris=out_tris, box_min=box_min, box_max=box_max, tri_idx=out_idx)
