"""ctypes binding and on-first-use build of the native window reader (the
port's own copy of estdepth_tpu/data/native/).

loader.cc decodes a training window's JPEG colour and 16-bit PNG depth with
one thread per frame, resizes them bilinearly and parses the poses, in one
call. It is built by g++ into `build/native/` at the root of the checkout,
under a name that carries a hash of the source and the command, so an
edited source is rebuilt and a stale library is never loaded. The build
holds a file lock, writes a temporary name and renames it into place:
processes that start together build it once, and none loads a library that
is still being written.

`available()` is False, and `build_error()` says why, where the toolchain
or the codec libraries are missing; the dataset's `backend="auto"` then
reads with cv2. Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().with_name("loader.cc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
LIBS = ["-ljpeg", "-lpng", "-lz", "-pthread"]
BUILD_TIMEOUT_S = 600

_lib = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes())
    digest.update(" ".join(FLAGS + LIBS).encode())
    return BUILD_DIR / f"libestloader-{digest.hexdigest()[:12]}.so"


def _build(out: Path) -> Optional[str]:
    """Compile loader.cc to `out` unless it exists; returns an error
    string or None."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():  # built by another process while this one waited
            return None
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = ["g++", *FLAGS, str(SOURCE), "-o", str(tmp), *LIBS]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=BUILD_TIMEOUT_S)
        except (OSError, subprocess.TimeoutExpired) as e:  # no toolchain
            tmp.unlink(missing_ok=True)
            return f"{' '.join(cmd)}: {e}"
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            return f"{' '.join(cmd)}:\n{proc.stderr[-2000:]}"
        os.replace(tmp, out)
    return None


def _load():
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        out = library_path()
        if not out.exists():
            _build_error = _build(out)
            if _build_error is not None:
                return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as e:
            _build_error = str(e)
            return None
        fp = ctypes.POINTER(ctypes.c_float)
        paths = ctypes.POINTER(ctypes.c_char_p)
        lib.est_load_window.argtypes = [
            paths, paths, paths, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            fp, fp, fp]
        lib.est_load_window.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_window(
    img_paths: List[str], depth_paths: List[str], pose_paths: List[str],
    width: int, height: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One window read by one native thread per frame: (imgs [N, H, W, 3]
    RGB in 0..255, depths [N, H, W] in metres, poses [N, 4, 4]), float32.
    Raises IOError if a frame cannot be read."""
    n = len(img_paths)
    if not (len(depth_paths) == len(pose_paths) == n):
        raise ValueError(f"a window of {n} images, {len(depth_paths)} "
                         f"depths and {len(pose_paths)} poses")
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native reader did not build: "
                           f"{_build_error}")
    imgs = np.empty((n, height, width, 3), np.float32)
    depths = np.empty((n, height, width), np.float32)
    poses = np.empty((n, 4, 4), np.float32)

    def carr(items):
        arr = (ctypes.c_char_p * n)()
        arr[:] = [p.encode() for p in items]
        return arr

    rc = lib.est_load_window(
        carr(img_paths), carr(depth_paths), carr(pose_paths), n, width,
        height, _fptr(imgs), _fptr(depths), _fptr(poses))
    if rc != 0:
        raise IOError(f"native window read failed ({rc}): {img_paths}")
    return imgs, depths, poses
