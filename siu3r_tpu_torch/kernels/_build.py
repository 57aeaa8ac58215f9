"""Build and load the port's CUDA kernels.

Every ``siu3r_tpu_torch/csrc/*.cu`` source (with the ``*.cuh`` headers
beside it) is compiled by ``nvcc`` for
``sm_90a`` (one process per source, all started together), the objects are
linked into one shared library with a plain C interface, and the library is
loaded through ``ctypes``. The build runs at first use, never at import, into
``build/kernels/`` at the root of the checkout; the library's name carries a
hash of the sources and headers, so an edited one is rebuilt.

Each kernel wrapper counts its launches in ``launch_counts`` (one per call of
its C entry that launched, nowhere else), so a run can show that a path went
through the kernels. One ``raster`` or ``raster_bwd`` count is two device
launches: the tile-ranking kernel (``order_tiles_kernel``), then the main one.
One ``bin`` count is three (``bin_prep_kernel``, ``bin_count_kernel``,
``bin_write_kernel``), after the wrapper's depth sort in torch. An ``msda``
count is one launch of one of two kernels, also counted in
``variant_counts`` as ``msda.staged`` (the head's value slice in shared
memory) or ``msda.global`` (taps read from global memory); likewise a
``flash_attn_rope_bf16`` count as ``flash_attn_rope_bf16.resident`` (the
head's K and V in shared memory) or ``.streamed``.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

launch_counts: collections.Counter = collections.Counter()
variant_counts: collections.Counter = collections.Counter()

_vp = ctypes.c_void_p
_i = ctypes.c_int
_ll = ctypes.c_longlong
_SIGNATURES = {
    "siu3r_flash_attn_fwd": [_vp] * 9 + [_i] * 5 + [_ll] * 9 + [ctypes.c_float, _vp],
    "siu3r_flash_attn_launch_config": [_i] * 5 + [ctypes.POINTER(_i)] * 3,
    "siu3r_flash_attn_rope_bf16_fwd": [_vp] * 8 + [_i] * 5 + [_ll] * 9 + [ctypes.c_float, _vp],
    "siu3r_flash_attn_bf16_launch_config": [_i] * 5 + [ctypes.POINTER(_i)] * 3,
    "siu3r_flash_attn_bf16_variant": [_i] * 2,
    "siu3r_msda_fwd": [_vp] * 6 + [_i] * 7 + [ctypes.POINTER(_i), _vp],
    "siu3r_bin_scratch_ints": [_i] * 4,
    "siu3r_bin_gaussians": [_vp] * 6 + [_i] * 9 + [_vp],
    "siu3r_raster_fwd": [_vp] * 9 + [_i] * 9 + [_ll] * 2 + [_vp],
    "siu3r_raster_fwd_launch_config": [_i] * 4 + [ctypes.POINTER(_i)],
    "siu3r_raster_bwd": [_vp] * 11 + [_i] * 9 + [_ll] * 2 + [_vp],
    "siu3r_raster_bwd_launch_config": [_i] * 4 + [ctypes.POINTER(_i)],
}


def reset_launch_counts() -> None:
    launch_counts.clear()
    variant_counts.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):  # the sources and the headers they include
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libsiu3r_kernels_{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile every source in parallel and link. Returns (library, seconds);
    ptxas' register and shared-memory report goes to ``build.log`` beside it.
    Safe when several processes build at once (the ranks of a data-parallel
    launch from a fresh checkout): each compiles and links in a directory of
    its own under ``build/kernels/`` and renames the library and the log into
    place, so no process reads another's half-written file."""
    lib = library_path()
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_DIR))
    try:
        return lib, _build_in(work, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _build_in(work: Path, lib: Path) -> float:
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in _sources():
        obj = work / f"{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    (work / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = work / lib.name
    link = subprocess.run(
        [nvcc, "-shared", *[str(o) for _, o, _ in procs], "-o", str(tmp)],
        capture_output=True, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(work / "build.log", BUILD_DIR / "build.log")
    os.replace(tmp, lib)
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build if needed, then load the kernels' shared library once."""
    lib_path, _ = build()
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
