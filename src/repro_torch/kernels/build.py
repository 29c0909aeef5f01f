"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  The build
runs at first use, all sources at once in parallel, into ``build/torch_ext/``
at the root of the checkout (listed in ``.gitignore``).  A library's file
name carries a hash of its sources and flags, so an edited source is
rebuilt and an unchanged one is reused.  A failed build raises; nothing
falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from repro_torch.obs.clock import monotonic

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
SOURCES = ("tree_attention", "decode_attention", "fused_swiglu", "kv_moves", "slot_write",
           "int4_matmul", "stream_matmul", "rms_norm", "latent_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# argument types of each library's exported launch function (void* for every
# pointer and the stream, so ctypes never truncates them to 32 bits)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    # q, k, v, mask, out, part_acc, part_ml, counters, then B, n, Hq, Hkv, hd, S,
    # split_keys, n_launch, kv_end, scale, dtype, stream
    "tree_attention": {
        "tree_attention_launch": [_P] * 8 + [_I] * 9 + [_F, _I, _P],
        "attention_rows_per_block": [_I],
    },
    # q, k, v, length, out, part_acc, part_ml, counters, then B, Hq, Hkv, hd, S, ...
    "decode_attention": {
        "decode_attention_launch": [_P] * 8 + [_I] * 8 + [_F, _I, _P],
        "attention_rows_per_block": [_I],
    },
    # x, wg, wu, out, part, counters, then M, K, N, k_per_split, splits,
    # rows_per_pass, dtype, stream
    "fused_swiglu": {"fused_swiglu_launch": [_P] * 6 + [_I] * 7 + [_P]},
    # the leaf table (L rows of arr, out, F, U as int64), L, src, dst, mask,
    # then B, S, M, elem_bytes, chunk_bytes, copy_through, stream
    "kv_moves": {"kv_move_leaves_launch": [_P, _I] + [_P] * 3 + [_I] * 6 + [_P]},
    # pointer-table arrays (dst, src, row, U, B), then L, slot, elem_bytes, stream
    "slot_write": {
        "slot_write_rows_launch": [_P] * 5 + [_I] * 3 + [_P],
        "slot_write_rows_max_leaves": [],
    },
    # x, qweight, scales, zeros, out, part, counters, then M, K, N, group,
    # k_per_split, splits, rows_per_pass, dtype, stream
    "int4_matmul": {"int4_matmul_launch": [_P] * 7 + [_I] * 8 + [_P]},
    # x, w, out, then M, K, N, tile_n, k_per_split, splits, dtype, stream; the
    # clusters of a plan the card holds at once (tile_n, splits, dtype)
    "stream_matmul": {
        "stream_matmul_launch": [_P] * 3 + [_I] * 7 + [_P],
        # x, w, out, then G, M, K, N, tile_n, k_per_split, splits, dtype, stream
        "stream_bmm_launch": [_P] * 3 + [_I] * 8 + [_P],
        "stream_matmul_max_clusters": [_I] * 3,
    },
    # x, w, out, then M, d, vec, tpr, nv, eps, dtype, stream
    "rms_norm": {"rms_norm_launch": [_P] * 3 + [_I] * 5 + [_F, _I, _P]},
    # q_lat, q_rope, ckv, krope, mask, out, then B, n, H, KL, RD, S, scale, dtype, stream
    "latent_attention": {"latent_attention_launch": [_P] * 6 + [_I] * 6 + [_F, _I, _P]},
}

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}  # name -> nvcc/ptxas output of this process's builds


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").is_file():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("repro_torch kernels: nvcc not found (set CUDA_HOME)")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> float:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns the seconds spent; raises with nvcc's output on any
    failure."""
    t0 = monotonic()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        path = _lib_path(name)
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{out}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("repro_torch kernel build failed:\n" + "\n".join(failed))
    return monotonic() - t0


def lib(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built on first use)."""
    if name not in _LIBS:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        cdll = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = ctypes.c_int
        cdll.cuda_error_string.argtypes = [ctypes.c_int]
        cdll.cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = cdll
    return _LIBS[name]


def check(name: str, rc: int) -> None:
    """Raise when a launch function of library ``name`` returned a CUDA
    error code."""
    if rc != 0:
        msg = lib(name).cuda_error_string(rc).decode()
        raise RuntimeError(f"repro_torch kernel library {name}: CUDA error {rc} ({msg})")
