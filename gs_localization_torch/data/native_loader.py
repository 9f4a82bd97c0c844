"""ctypes binding of the native threaded image decoder (``native/loader.cpp``).

The shared library is compiled at first use with
``g++ -O3 -fPIC -std=c++17 -shared ... -lpng -ljpeg -lz -lpthread`` (the
flags of ``native/Makefile``) into ``build/native_loader/`` beside the
package, under a name that carries a hash of the source and the command;
nothing is written into ``native/``. Host decoding only: the decoded
arrays are numpy, and the training loop copies them to the device.

    loader = NativeLoader(n_threads=4)
    loader.submit(tag=0, path="img.png", kind=KIND_RGB)
    tag, array = loader.fetch()        # (H, W, 3) float32 in [0, 1]

``NativeLoader.available()`` is False when the library cannot be built
(no compiler, no libpng/libjpeg headers); ``build_error()`` then says
why, and callers read images with PIL (``data.scene.load_image``, the
default of ``train_map``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

KIND_RGB = 0
KIND_DEPTH16 = 1

SOURCE = Path(__file__).resolve().parents[2] / "native" / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native_loader"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LIBS = ("-lpng", "-ljpeg", "-lz", "-lpthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libgsl_loader_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, out.name)
        cmd = [cxx, *CXX_FLAGS, "-o", lib, str(SOURCE), *LIBS]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            lines = proc.stderr.strip().splitlines() or [""]
            why = next((ln for ln in lines if "error" in ln), lines[-1])
            raise RuntimeError(f"g++ exit {proc.returncode}: {why.strip()}")
        os.replace(lib, out)     # atomic: concurrent builds agree


def _load_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None (and the reason in
    ``build_error()``) if it cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            out = library_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _error = f"{type(e).__name__}: {e}"
            return None
        lib.gsl_create.restype = ctypes.c_void_p
        lib.gsl_create.argtypes = [ctypes.c_int]
        lib.gsl_destroy.restype = None
        lib.gsl_destroy.argtypes = [ctypes.c_void_p]
        lib.gsl_submit.restype = ctypes.c_int
        lib.gsl_submit.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                   ctypes.c_char_p, ctypes.c_int]
        lib.gsl_fetch.restype = ctypes.c_long
        lib.gsl_fetch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ]
        lib.gsl_peek_size.restype = ctypes.c_int
        lib.gsl_peek_size.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.gsl_last_error.restype = ctypes.c_char_p
        lib.gsl_last_error.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def build_error() -> Optional[str]:
    """Why the library is unavailable, or None if it loaded."""
    _load_lib()
    return _error


class NativeLoader:
    """Async threaded decoder. Not fork-safe; one per process."""

    def __init__(self, n_threads: int = 4,
                 initial_capacity: int = 1920 * 1080 * 3):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_error}")
        self._lib = lib
        self._h = lib.gsl_create(n_threads)
        self._buf = np.empty(initial_capacity, np.float32)

    @staticmethod
    def available() -> bool:
        return _load_lib() is not None

    def submit(self, tag: int, path: str, kind: int = KIND_RGB) -> None:
        self._lib.gsl_submit(self._h, tag, path.encode(), kind)

    def fetch(self) -> Tuple[int, np.ndarray]:
        """The next decoded image as (tag, array): (H, W, 3) float32 in
        [0, 1] for KIND_RGB, (H, W) metres for KIND_DEPTH16 (65535 reads
        as 0). Raises IOError on a decode failure."""
        w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        while True:
            tag = self._lib.gsl_fetch(
                self._h, ctypes.byref(w), ctypes.byref(h), ctypes.byref(c),
                self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self._buf.size)
            if tag == -2:          # the buffer is too small: grow and retry
                self._lib.gsl_peek_size(self._h, ctypes.byref(w),
                                        ctypes.byref(h), ctypes.byref(c))
                self._buf = np.empty(w.value * h.value * max(c.value, 1),
                                     np.float32)
                continue
            if tag == -1:
                raise IOError(self._lib.gsl_last_error(self._h).decode())
            n = w.value * h.value * c.value
            arr = self._buf[:n].reshape(h.value, w.value, c.value).copy()
            if c.value == 1:
                arr = arr[:, :, 0]
            return tag, arr

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.gsl_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        self.close()


class PrefetchingSceneLoader:
    """Image/depth loader for training: decodes requested views on the
    native threads and serves them by uid, cached on the host. An instance
    is a ``train_map`` ``image_loader`` (``PIL`` is the default there)."""

    def __init__(self, n_threads: int = 4, cache: bool = True):
        self._loader = NativeLoader(n_threads)
        self._cache: dict = {}
        self._pending: dict = {}
        self._next_tag = 0
        self._tags: dict = {}
        self._use_cache = cache

    def request(self, uid: int, image_path: str,
                depth_path: Optional[str] = None) -> None:
        if uid in self._cache or uid in self._pending:
            return
        tag_img = self._next_tag
        self._next_tag += 1
        self._loader.submit(tag_img, image_path, KIND_RGB)
        tag_dep = None
        if depth_path and os.path.exists(depth_path):
            tag_dep = self._next_tag
            self._next_tag += 1
            self._loader.submit(tag_dep, depth_path, KIND_DEPTH16)
        self._pending[uid] = {"img": tag_img, "dep": tag_dep,
                              "img_data": None, "dep_data": None}
        self._tags[tag_img] = (uid, "img")
        if tag_dep is not None:
            self._tags[tag_dep] = (uid, "dep")

    def __call__(self, info):
        """(rgb, depth or None) of a ``CameraInfo``."""
        self.request(info.uid, info.image_path, info.depth_path)
        return self.get(info.uid)

    def get(self, uid: int):
        """(rgb, depth or None) of a requested uid, waiting for it."""
        if uid in self._cache:
            return self._cache[uid]
        if uid not in self._pending:
            raise KeyError(f"uid {uid} was never requested")
        while uid in self._pending:
            tag, arr = self._loader.fetch()
            puid, kind = self._tags.pop(tag)
            ent = self._pending[puid]
            ent[f"{kind}_data"] = arr
            img_done = ent["img_data"] is not None
            dep_done = ent["dep"] is None or ent["dep_data"] is not None
            if img_done and dep_done:
                result = (ent["img_data"], ent["dep_data"])
                del self._pending[puid]
                if self._use_cache:
                    self._cache[puid] = result
                if puid == uid:
                    return result
        return self._cache[uid]
