"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` source compiles with `nvcc` for `sm_90a` (one `nvcc`
process per source, all started together), and the objects link into one
shared library with a plain C interface, loaded with `ctypes`. Nothing
includes PyTorch's headers, so a cold build takes seconds, not minutes.

The library lands in `build/srtpu_torch_kernels/` at the repository root
when the package sits in a checkout of the repository, and otherwise (an
installed package) in `$XDG_CACHE_HOME/srtpu_torch_kernels/` (default
`~/.cache`); `SRTPU_TORCH_BUILD_DIR` overrides both. It is named by a
digest of the sources: a changed source builds anew, an unchanged one
loads the library already there. The build runs at the first kernel
launch, never at import, so the package imports where no `nvcc` exists.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"


def _build_dir() -> Path:
    env = os.environ.get("SRTPU_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    root = Path(__file__).resolve().parents[2]
    if (root / "pyproject.toml").is_file() and (root / ".gitignore").is_file():
        return root / "build" / "srtpu_torch_kernels"
    cache = (os.environ.get("XDG_CACHE_HOME")
             or os.path.join(os.path.expanduser("~"), ".cache"))
    return Path(cache) / "srtpu_torch_kernels"


BUILD_DIR = _build_dir()
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
#: C entry points: name -> argtypes (every one returns a cudaError_t)
_SIGNATURES = {
    "srtpu_compact_perm": [_P, _I, _P, _P, _P, _P],
    "srtpu_probe_ranges": [_P, _I, _I, _P, _P, _L, _P, _P, _P, _P, _I,
                           _P],
    "srtpu_expand_gather_maps": [_P, _P, _I, _I, _P, _P, _P, _P, _I, _P],
    "srtpu_seg_sum_count": [_I, _I, _P, _P, _P, _P, _L, _I, _P, _P, _P, _I,
                            _I, _P],
    "srtpu_bloom_build": [_P, _I, _L, _P, _I, _I, _P, _P],
    "srtpu_bloom_probe": [_P, _I, _L, _P, _I, _I, _P, _P, _L, _P, _I, _P],
    "srtpu_murmur3": [_P, _I, _L, _I, _P, _I, _P, _I, _P],
    "srtpu_partition_by_ids": [_P, _L, _P, _L, _I, _P, _P, _P, _P],
    "srtpu_gather_leaves": [_P, _I, _L, _I, _P],
    "srtpu_pack_keys": [_P, _I, _I, _P, _L, _P, _P, _I, _P],
    "srtpu_sort_words": [_P, _I, _I, _P, _P, _I, _P],
    "srtpu_group_bounds": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "srtpu_dense_bin_perm": [_P, _I, _P, _P, _P, _I, _P],
    "srtpu_seg_minmax": [_I, _I, _P, _P, _P, _L, _I, _P, _I, _I, _P],
    "srtpu_merge_runs": [_P, _L, _P, _L, _I, _P, _P, _L, _P, _I, _P, _I, _I,
                         _P],
    "srtpu_window_prefix": [_I, _P, _P, _P, _P, _P, _L, _P, _P, _P, _P],
    "srtpu_window_inverse": [_P, _L, _P, _L, _L, _I, _P],
    "srtpu_window_eval": [_P, _I, _L, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                          _I, _I, _P],
    "srtpu_range_bounds": [_I, _I, _P, _P, _P, _P, _L, _I, _L, _L, _D, _D,
                           _P, _P, _P, _P, _P, _P, _P, _I, _P],
    "srtpu_frame_minmax": [_I, _I, _P, _P, _P, _P, _L, _P, _P, _P, _P, _P,
                           _P, _P, _P, _P, _P, _I, _P],
    "srtpu_frame_pick": [_P, _I, _L, _P, _P, _P, _P, _P, _P, _I, _P],
    "srtpu_dfa_match": [_P, _P, _L, _I, _P, _P, _I, _I, _P, _I, _P, _I, _I,
                        _P],
    "srtpu_str_find": [_I, _P, _P, _L, _I, _P, _I, _L, _P, _P, _I, _P],
    "srtpu_str_rewrite": [_I, _P, _P, _L, _I, _P, _L, _L, _P, _P, _P, _P,
                          _I, _I, _I, _I, _P],
    "srtpu_str_assemble": [_I, _P, _I, _L, _P, _I, _L, _P, _P, _I, _P, _I,
                           _P],
    "srtpu_str_parse": [_I, _P, _L, _P, _P, _L, _I, _L, _L, _P, _P, _I, _P],
    "srtpu_tz_rebase": [_I, _P, _L, _P, _P, _P, _I, _P, _I, _P],
    "srtpu_str_format": [_I, _P, _I, _L, _P, _I, _P, _I, _P, _I, _P],
    "srtpu_rank_select": [_P, _P, _P, _P, _L, _I, _I, _D, _P, _P, _I, _P],
    "srtpu_rank_interp": [_P, _P, _I, _I, _D, _P, _I, _P],
    "srtpu_collect_rank": [_P, _I, _P, _P, _L, _I, _I, _P, _P, _P, _P, _I,
                           _P],
    "srtpu_collect_scatter": [_P, _I, _P, _P, _P, _L, _P, _I, _I, _P, _P,
                              _I, _P],
    "srtpu_join_marks": [_P, _I, _P, _L, _L, _I, _I, _P, _I, _P],
    "srtpu_build_coverage": [_P, _P, _L, _I, _P, _P, _I, _P],
    "srtpu_round_robin_partition": [_L, _P, _L, _I, _L, _P, _P, _P, _P],
    "srtpu_codes_remap": [_P, _I, _L, _P, _I, _P, _I, _P],
    "srtpu_xxhash64": [_P, _I, _L, _L, _P, _P, _I, _P],
    "srtpu_decimal128": [_I, _P, _I, _I, _P, _I, _I, _P, _P, _L, _I, _I, _P,
                         _P, _I, _P],
    "srtpu_seg_sum128": [_P, _I, _P, _P, _L, _I, _P, _P, _P, _I, _I, _P],
    "srtpu_frame_collect": [_P, _I, _P, _P, _P, _P, _P, _L, _L, _L, _I, _I,
                            _P, _P, _P, _I, _P],
    "srtpu_array_rows": [_I, _I, _I, _P, _P, _P, _P, _P, _L, _I, _P, _P, _P,
                         _P, _I, _P],
    "srtpu_zorder_interleave": [_P, _I, _L, _I, _I, _P, _I, _P],
    "srtpu_exchange_slots": [_P, _L, _P, _L, _I, _L, _P, _P, _P, _P, _P,
                             _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: seconds the last build took in this process (0.0 when it loaded a
#: library already built)
build_seconds = 0.0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from source at first use")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources if their library is not built yet; return its
    path. Raises with nvcc's output when a compile fails."""
    global build_seconds
    out = BUILD_DIR / f"libsrtpu_kernels_{_digest()}.so"
    if out.exists():
        return out
    t0 = time.monotonic()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmp, src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                 "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for src, _, p in procs:
            log = p.communicate()[0].decode(errors="replace")
            if p.returncode != 0:
                errors.append(f"{src.name}:\n{log}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_so = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp_so,
             *[obj for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace"))
        os.replace(tmp_so, out)  # atomic: a concurrent loader sees all or none
    build_seconds = time.monotonic() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            so.srtpu_sort_scratch_bytes.argtypes = [_I, _I]
            so.srtpu_sort_scratch_bytes.restype = ctypes.c_longlong
            so.srtpu_error_string.argtypes = [ctypes.c_int]
            so.srtpu_error_string.restype = ctypes.c_char_p
            _lib = so
        return _lib


def check(code: int, kernel: str) -> None:
    """Raise when a kernel's C entry point returned a CUDA error."""
    if code != 0:
        msg = lib().srtpu_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA error {code} ({msg})")
