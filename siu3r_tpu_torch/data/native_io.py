"""ctypes bindings for the native IO runtime (``native/siu3r_io.cpp``), a
copy of ``siu3r_tpu/data/native_io.py``.

Compiles the shared library on first use with ``native/Makefile`` (g++ with
libjpeg and libpng) into ``build/native/`` at the root of the checkout, its
own directory beside the JAX package's ``native/libsiu3r_io.so``: each
process builds in a directory of its own and renames the result into place,
so concurrent first uses do not race. Falls back to PIL (host-side decoding)
when the toolchain or libraries are unavailable; ``decode_batch`` and the
other functions give the same results either way.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_NATIVE_DIR = _ROOT / "native"
_BUILD_DIR = _ROOT / "build" / "native"
_LIB_PATH = _BUILD_DIR / "libsiu3r_io.so"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    work = _BUILD_DIR / f"tmp-{os.getpid()}"
    try:
        work.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            ["make", "-s", "-f", str(_NATIVE_DIR / "Makefile"), f"--eval=vpath %.cpp {_NATIVE_DIR}"],
            cwd=work, check=True, capture_output=True,
        )
        os.replace(work / _LIB_PATH.name, _LIB_PATH)
        return True
    except (OSError, subprocess.CalledProcessError):
        return False
    finally:
        shutil.rmtree(work, ignore_errors=True)


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _LIB_PATH.exists() and not _build():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    lib.sio_decode_jpeg.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.sio_decode_png_rgb.argtypes = lib.sio_decode_jpeg.argtypes
    lib.sio_decode_png_gray16.argtypes = lib.sio_decode_jpeg.argtypes
    lib.sio_image_size.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.sio_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.sio_pack_segments.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.sio_unpack_segments.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    for fn in ("sio_decode_jpeg", "sio_decode_png_rgb", "sio_decode_png_gray16", "sio_image_size",
               "sio_decode_batch"):
        getattr(lib, fn).restype = ctypes.c_int
    for fn in ("sio_pack_segments", "sio_unpack_segments"):
        getattr(lib, fn).restype = None
    _lib = lib
    return _lib


def pack_segment_rgb(sem: np.ndarray, ins: np.ndarray) -> np.ndarray:
    """segment_id = 1000*sem + inst -> RGB little-endian base-256 (reference
    visualizer.py:486-503; the JAX package's ``visualizer.pack_segment_rgb``)."""
    seg = (1000 * sem.astype(np.int64) + ins.astype(np.int64)).clip(0)
    return np.stack(
        [seg % 256, (seg // 256) % 256, seg // 65536], axis=-1
    ).astype(np.uint8)


def image_size(path: str) -> tuple[int, int]:
    lib = get_lib()
    if lib is not None:
        w = ctypes.c_int()
        h = ctypes.c_int()
        if lib.sio_image_size(str(path).encode(), ctypes.byref(w), ctypes.byref(h)) == 0:
            return w.value, h.value
    from PIL import Image

    with Image.open(path) as im:
        return im.size


def decode_batch(
    paths: Sequence[str], kind: str, width: int, height: int, n_threads: int = 8
) -> np.ndarray:
    """kind: 'jpeg' | 'png_rgb' | 'png_gray16'. Returns [N, H, W, 3] uint8 or
    [N, H, W] uint16."""
    n = len(paths)
    kind_id = {"jpeg": 0, "png_rgb": 1, "png_gray16": 2}[kind]
    lib = get_lib()
    if lib is not None:
        if kind_id == 2:
            out = np.empty((n, height, width), np.uint16)
        else:
            out = np.empty((n, height, width, 3), np.uint8)
        arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
        rc = lib.sio_decode_batch(
            arr, n, kind_id, out.ctypes.data_as(ctypes.c_void_p),
            width, height, n_threads,
        )
        if rc == 0:
            return out
    # PIL fallback
    from PIL import Image

    imgs = []
    for p in paths:
        with Image.open(p) as im:
            if kind_id == 2:
                imgs.append(np.asarray(im).astype(np.uint16))
            else:
                imgs.append(np.asarray(im.convert("RGB")))
    return np.stack(imgs)


def pack_segments(sem: np.ndarray, ins: np.ndarray) -> np.ndarray:
    lib = get_lib()
    if lib is None:
        return pack_segment_rgb(sem, ins)
    sem32 = np.ascontiguousarray(sem, np.int32)
    ins32 = np.ascontiguousarray(ins, np.int32)
    rgb = np.empty(sem32.shape + (3,), np.uint8)
    lib.sio_pack_segments(
        sem32.ctypes.data_as(ctypes.c_void_p),
        ins32.ctypes.data_as(ctypes.c_void_p),
        rgb.ctypes.data_as(ctypes.c_void_p),
        sem32.size,
    )
    return rgb


def unpack_segments(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    lib = get_lib()
    rgb = np.ascontiguousarray(rgb[..., :3], np.uint8)
    if lib is None:
        seg = (
            rgb[..., 0].astype(np.int64)
            + rgb[..., 1].astype(np.int64) * 256
            + rgb[..., 2].astype(np.int64) * 65536
        )
        return (seg // 1000).astype(np.int32), (seg % 1000).astype(np.int32)
    sem = np.empty(rgb.shape[:-1], np.int32)
    ins = np.empty(rgb.shape[:-1], np.int32)
    lib.sio_unpack_segments(
        rgb.ctypes.data_as(ctypes.c_void_p),
        sem.ctypes.data_as(ctypes.c_void_p),
        ins.ctypes.data_as(ctypes.c_void_p),
        sem.size,
    )
    return sem, ins
