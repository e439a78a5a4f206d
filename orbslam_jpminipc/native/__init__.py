"""Native (C++) runtime for the sequential map-graph maintenance loops.

The compute path of this framework is JAX/XLA; this module is the native
host runtime AROUND it — the role C++ plays in the reference (KeyFrame
covisibility/culling internals, local-BA graph assembly). Builds
libmapgraph from mapgraph.cpp with g++ on first use, into `build/` beside
this file (ignored by git), under a name keyed by the source's content
hash, so an edited source or a fresh checkout always gets its own build.
Falls back to the pure-Python implementations when no toolchain is
available.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "mapgraph.cpp")
BUILD_DIR = os.path.join(_DIR, "build")

_lib = None


def lib_path() -> str:
    """Where the library built from the current source lives."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libmapgraph-{digest}.so")


def _build(so: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", tmp],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, so)  # atomic: concurrent builders race harmlessly
        return True
    except Exception as e:  # noqa: BLE001
        print(f"[native] mapgraph build failed ({e}); using Python fallback",
              file=sys.stderr)
        return False


def get_lib():
    """The loaded library, or None (Python fallbacks apply)."""
    global _lib
    if _lib is not None:
        return _lib
    so = lib_path()
    if not os.path.exists(so) and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:
        print(f"[native] mapgraph load failed ({e})", file=sys.stderr)
        return None

    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.cull_redundant_keyframes.restype = ctypes.c_int
    lib.cull_redundant_keyframes.argtypes = [
        i32p, ctypes.c_int, i32p, i32p, u8p, i32p, i32p, u8p, i32p, i32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, i32p,
    ]
    lib.build_ba_obs.restype = ctypes.c_int
    lib.build_ba_obs.argtypes = [
        i64p, ctypes.c_int, i32p, i32p, i32p, ctypes.c_int,
        i32p, i32p, i32p, i32p, i32p, ctypes.c_int,
    ]
    lib.add_observations.restype = ctypes.c_int
    lib.add_observations.argtypes = [
        i32p, i32p, ctypes.c_int, ctypes.c_int,
        i32p, i32p, i32p, u8p, ctypes.c_int, ctypes.c_int,
    ]
    _lib = lib
    return _lib


def _p32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _p64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _pu8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def cull_redundant_keyframes_native(state, candidates, redundancy=0.9):
    """Native KeyFrameCulling over the MapState's buffers. Returns the list
    of erased keyframes, or None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    cands = np.ascontiguousarray(np.asarray(candidates, np.int32))
    out = np.empty(max(len(cands), 1), np.int32)
    kf_valid = state.kf_valid.view(np.uint8)
    mp_valid = state.mp_valid.view(np.uint8)
    state._covis_cache = None  # C++ erases KFs/observations directly
    n = lib.cull_redundant_keyframes(
        _p32(cands), len(cands),
        _p32(state.kf_point), _p32(state.kf_level), _pu8(kf_valid),
        _p32(state.mp_obs_kf), _p32(state.mp_obs_feat), _pu8(mp_valid),
        _p32(state.mp_gen), _p32(state.kf_parent),
        state.max_kf, state.n_feat, state.max_mp, state.max_obs,
        ctypes.c_float(redundancy), _p32(out),
    )
    return [int(x) for x in out[:n]]


def build_ba_obs_native(state, pts, kf_index_of, max_out):
    """Native local-BA observation assembly. Returns arrays
    (obs_kf, obs_pt, obs_feat, src_p, src_k) of length n, or None."""
    lib = get_lib()
    if lib is None:
        return None
    pts64 = np.ascontiguousarray(np.asarray(pts, np.int64))
    kidx = np.ascontiguousarray(np.asarray(kf_index_of, np.int32))
    out_kf = np.empty(max_out, np.int32)
    out_pt = np.empty(max_out, np.int32)
    out_feat = np.empty(max_out, np.int32)
    out_sp = np.empty(max_out, np.int32)
    out_sk = np.empty(max_out, np.int32)
    n = lib.build_ba_obs(
        _p64(pts64), len(pts64),
        _p32(state.mp_obs_kf), _p32(state.mp_obs_feat), _p32(kidx),
        state.max_obs,
        _p32(out_kf), _p32(out_pt), _p32(out_feat), _p32(out_sp), _p32(out_sk),
        max_out,
    )
    return out_kf[:n], out_pt[:n], out_feat[:n], out_sp[:n], out_sk[:n]


def add_observations_native(state, kf, feats, points):
    """Native batch AddObservation. Returns inserted count, or None."""
    lib = get_lib()
    if lib is None:
        return None
    f32 = np.ascontiguousarray(np.asarray(feats, np.int32))
    p32 = np.ascontiguousarray(np.asarray(points, np.int32))
    mp_valid = state.mp_valid.view(np.uint8)
    state._covis_cache = None  # C++ writes kf_point/mp_obs directly
    return lib.add_observations(
        _p32(f32), _p32(p32), len(f32), int(kf),
        _p32(state.kf_point), _p32(state.mp_obs_kf), _p32(state.mp_obs_feat),
        _pu8(mp_valid), state.n_feat, state.max_obs,
    )
