"""ctypes bridge to the C++ native runtime components (native/rtt_native.cpp).

Every entry point degrades gracefully to the pure-Python implementation when
the shared library hasn't been built (``make -C native``); callers check for
``None`` returns.
"""

from __future__ import annotations

import ctypes
import logging
import os
from typing import List, Optional

import numpy as np

logger = logging.getLogger("ray_tracer.native")

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "librtt_native.so")
_lib = None
_load_failed = False


def _try_build():
    """`make -C native` when the library is absent (the .so is a build
    artifact, not committed). Opt-in via RTT_AUTOBUILD=1 — an implicit
    compile during scene build would surprise sandboxed/offline hosts; the
    default is the pure-Python path."""
    if os.environ.get("RTT_AUTOBUILD", "0") != "1":
        logger.info(
            "librtt_native.so not built; using pure-Python loaders "
            "(run `make -C native` or set RTT_AUTOBUILD=1 to enable the "
            "native ones)")
        return
    import subprocess
    logger.info("building librtt_native.so (RTT_AUTOBUILD=1) ...")
    try:
        subprocess.run(["make", "-C", os.path.dirname(_LIB_PATH)],
                       capture_output=True, timeout=120, check=False)
    except Exception as e:
        logger.warning("native build failed: %s", e)


def _get_lib():
    global _lib, _load_failed
    if _lib is None and not _load_failed:
        if not os.path.exists(_LIB_PATH):
            _try_build()
        try:
            lib = ctypes.CDLL(_LIB_PATH)
            lib.rtt_obj_load.restype = ctypes.c_void_p
            lib.rtt_obj_load.argtypes = [ctypes.c_char_p]
            lib.rtt_obj_num_objects.argtypes = [ctypes.c_void_p]
            lib.rtt_obj_counts.argtypes = [
                ctypes.c_void_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int)]
            lib.rtt_obj_strings.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
            lib.rtt_obj_fill.argtypes = [
                ctypes.c_void_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint32)]
            lib.rtt_obj_free.argtypes = [ctypes.c_void_p]
            lib.rtt_morton_order.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64)]
            _lib = lib
        except OSError:
            _load_failed = True
    return _lib


def available() -> bool:
    return _get_lib() is not None


def morton_order(centroids: np.ndarray) -> Optional[np.ndarray]:
    """Morton argsort of (N, 3) centroids; None if the library is absent."""
    lib = _get_lib()
    if lib is None:
        return None
    c = np.ascontiguousarray(centroids, np.float32)
    n = c.shape[0]
    out = np.empty(n, np.int64)
    lib.rtt_morton_order(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


def parse_obj(path: str) -> Optional[List[dict]]:
    """Fast OBJ parse → list of dicts(name, material, mtllib, positions,
    normals, uvs|None, indices); None if the library is absent or the file
    can't be read."""
    lib = _get_lib()
    if lib is None:
        return None
    h = lib.rtt_obj_load(path.encode())
    if not h:
        return None
    try:
        out = []
        for i in range(lib.rtt_obj_num_objects(h)):
            nv = ctypes.c_int64()
            ni = ctypes.c_int64()
            has_uv = ctypes.c_int()
            lib.rtt_obj_counts(h, i, ctypes.byref(nv), ctypes.byref(ni),
                               ctypes.byref(has_uv))
            name = ctypes.create_string_buffer(256)
            material = ctypes.create_string_buffer(256)
            mtllib = ctypes.create_string_buffer(256)
            lib.rtt_obj_strings(h, i, name, material, mtllib, 256)
            pos = np.empty((nv.value, 3), np.float32)
            nrm = np.empty((nv.value, 3), np.float32)
            uv = np.empty((nv.value, 2), np.float32)
            idx = np.empty(ni.value, np.uint32)
            lib.rtt_obj_fill(
                h, i,
                pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                nrm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                uv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
            out.append(dict(
                name=name.value.decode(errors="replace"),
                material=material.value.decode(errors="replace"),
                mtllib=mtllib.value.decode(errors="replace"),
                positions=pos, normals=nrm,
                uvs=uv if has_uv.value else None, indices=idx))
        return out
    finally:
        lib.rtt_obj_free(h)
