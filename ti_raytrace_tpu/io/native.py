"""ctypes bindings for the native host runtime (native/tiray_native.cpp).

Builds the shared library from source with g++ at first use, into
native/build/ (untracked; rebuilt when the source is newer); every entry
point has a pure-Python fallback, so the framework works without a
toolchain.  Parsing semantics are asserted equal to io/obj.py
in tests/test_native.py.
"""

import ctypes
import os
import subprocess
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "tiray_native.cpp")
_SO = os.path.join(_ROOT, "native", "build", "libtiray_native.so")

_lock = threading.Lock()
_lib = None
_failed = False


def _build() -> bool:
    """Compile into a private temporary file and publish it atomically:
    several processes (test workers) may build at once."""
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, _SO)
    return True


def get_lib():
    """The loaded library, or None if unavailable."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            if not _build():
                _failed = True
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            _failed = True
            return None
        lib.tiray_obj_load.restype = ctypes.c_void_p
        lib.tiray_obj_load.argtypes = [ctypes.c_char_p]
        lib.tiray_obj_free.argtypes = [ctypes.c_void_p]
        lib.tiray_obj_error.restype = ctypes.c_char_p
        lib.tiray_obj_error.argtypes = [ctypes.c_void_p]
        lib.tiray_obj_num_materials.restype = ctypes.c_int32
        lib.tiray_obj_num_materials.argtypes = [ctypes.c_void_p]
        lib.tiray_obj_material_tris.restype = ctypes.c_int32
        lib.tiray_obj_material_tris.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.tiray_obj_material_params.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_float)
        ]
        lib.tiray_obj_material_name.restype = ctypes.c_char_p
        lib.tiray_obj_material_name.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.tiray_obj_material_has_texture.restype = ctypes.c_int32
        lib.tiray_obj_material_has_texture.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.tiray_obj_material_soup.argtypes = [
            ctypes.c_void_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.tiray_morton3d.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint32),
        ]
        _lib = lib
        return _lib


def load_obj_native(path: str):
    """Native OBJ load -> ObjMesh (same structure as io.obj.load_obj),
    or None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    from ti_raytrace_tpu.io.obj import ObjMaterial, ObjMesh

    h = lib.tiray_obj_load(path.encode())
    try:
        err = lib.tiray_obj_error(h)
        if err:
            return None
        mesh = ObjMesh()
        n_mat = lib.tiray_obj_num_materials(h)
        for mi in range(n_mat):
            p = (ctypes.c_float * 9)()
            lib.tiray_obj_material_params(h, mi, p)
            mat = ObjMaterial(
                name=lib.tiray_obj_material_name(h, mi).decode(),
                diffuse=(p[0], p[1], p[2]),
                emissive=(p[3], p[4], p[5]),
                shininess=p[6],
                optical_density=p[7],
                transparency=p[8],
                texture="tex" if lib.tiray_obj_material_has_texture(h, mi) else None,
            )
            mesh.materials.append(mat)
            t = lib.tiray_obj_material_tris(h, mi)
            pos = np.zeros((t, 3, 3), np.float32)
            nrm = np.zeros((t, 3, 3), np.float32)
            uv = np.zeros((t, 3, 2), np.float32)
            if t:
                lib.tiray_obj_material_soup(
                    h, mi,
                    pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    nrm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    uv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                )
            mesh.tri_pos.append(pos)
            mesh.tri_normal.append(nrm)
            mesh.tri_uv.append(uv)
        return mesh
    finally:
        lib.tiray_obj_free(h)


def morton3d_native(centroids: np.ndarray, lo, hi):
    """Native 30-bit morton codes, or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    c = np.ascontiguousarray(centroids, np.float32)
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    out = np.zeros((c.shape[0],), np.uint32)
    lib.tiray_morton3d(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(c.shape[0]),
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        hi.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return out
