"""Build the package's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by ``nvcc`` into ``build/viet_tts_torch/<name>-<hash>.so`` under the
checkout (the hash is of the source and of the shared ``csrc/*.cuh``
headers, so an edited kernel is rebuilt). All
sources are compiled together, one ``nvcc`` process each, the first time
any kernel is asked for. Nothing here runs at import time: the CPU tests
import every module, and this machine may have no ``nvcc``.

    lib = kernels.library("flash_xl_attention")   # ctypes.CDLL, argtypes set
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Tuple

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "viet_tts_torch")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_U64 = ctypes.c_uint64

# C signatures of each source's entry points: name -> (restype, argtypes)
SIGNATURES: Dict[str, Dict[str, Tuple[object, List[object]]]] = {
    "flash_xl_attention": {
        # K1: q, k, v, pad, out, lse, B, T, Tp, H, D, is_bf16, scale,
        # dropout_p, seed, stream
        "vt_flash_attn_fwd": (
            _I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _D, _U64, _P]
        ),
        # qc, k, v, qv, p, pad, out, lse, B, T, H, D, is_bf16, scale,
        # dropout_p, seed, stream
        "vt_flash_xl3_fwd": (
            _I, [_P, _P, _P, _P, _P, _P, _P, _P,
                 _I, _I, _I, _I, _I, _F, _D, _U64, _P]
        ),
        # qc, k, v, g, table, gab, pad, out, lse, B, T, Tp, H, D, E,
        # is_bf16, scale, dropout_p, seed, stream
        "vt_flash_xl2_fwd": (
            _I, [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                 _I, _I, _I, _I, _I, _I, _I, _F, _D, _U64, _P]
        ),
        # qc, k, v, gA, gB, table, pad, out, lse, B, T, Tp, H, D, E, is_bf16,
        # scale, dropout_p, seed, stream
        "vt_flash_xl_fwd": (
            _I, [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                 _I, _I, _I, _I, _I, _I, _I, _F, _D, _U64, _P]
        ),
        # K7: qc, k, v, g, table, pad, out, lse, B, T, Tp, H, D, E, is_bf16,
        # scale, dropout_p, seed, stream
        "vt_flash_rel_fwd": (
            _I, [_P] * 8 + [_I] * 7 + [_F, _D, _U64, _P]
        ),
        "vt_error_string": (ctypes.c_char_p, [_I]),
    },
    "flash_xl_attention_bwd": {
        # K3's Q1: q, k, v, g, pad, lse, delta, dq, s, p, B, T, Tp, H, D,
        # is_bf16, scale, dropout_p, seed, stream
        "vt_flash_attn_bwd_q1": (_I, [_P] * 10 + [_I] * 6 + [_F, _D, _U64, _P]),
        # K3's bwd-kv: q, g, s, p, dk, dv, B, T, H, D, is_bf16, stream
        "vt_flash_attn_bwd_kv": (_I, [_P] * 6 + [_I] * 5 + [_P]),
        # qc, k, v, qv, p, g, pad, lse, delta, dqc, dk, dv, dqv, dp, dqv_b,
        # part, s, pm, B, T, H, D, is_bf16, scale, dropout_p, seed, stream
        "vt_flash_xl3_bwd": (
            _I, [_P] * 18 + [_I, _I, _I, _I, _I, _F, _D, _U64, _P]
        ),
        # qc, k, v, ga, gb, table, g, pad, lse, delta, dqc, gab, s, p, B, T,
        # Tp, H, D, E, is_bf16, pos (0 K6, 1 K5, 2 K7), scale, dropout_p,
        # seed, stream
        "vt_xl_bwd_q1": (
            _I, [_P] * 14 + [_I] * 8 + [_F, _D, _U64, _P]
        ),
        # s, table, dg, dgb, B, T, H, E, is_bf16, pos, stream
        "vt_xl_bwd_q2": (_I, [_P] * 4 + [_I] * 6 + [_P]),
        # qc, g, s, p, dk, dv, B, T, H, D, is_bf16, stream
        "vt_xl_bwd_kv": (_I, [_P] * 6 + [_I] * 5 + [_P]),
        # s, ga, gb (null: K7's form), part, dtab, n_split, bh_per, B, T, H,
        # E, is_bf16, stream
        "vt_xl_bwd_dtab": (_I, [_P] * 5 + [_I] * 7 + [_P]),
        "vt_error_string": (ctypes.c_char_p, [_I]),
    },
    "fused_mrf": {
        # src, wp (packed hi / lo taps), b1, b2, hout, accin, accout, acc_div,
        # B, T, C, seq_len, K, dil, slope, stream
        "vt_mrf_pair": (
            _I,
            [_P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _I, _F, _P],
        ),
        "vt_error_string": (ctypes.c_char_p, [_I]),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels can only be built "
                       "where the CUDA toolkit is installed")


def _target(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build_all() -> Dict[str, str]:
    """Compile every source that has no up-to-date library, all at once.

    Returns the path of each library. Raises with nvcc's output when a
    source does not compile."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    targets = {name: _target(name) for name in SIGNATURES}
    procs = {}
    for name, so in targets.items():
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        _build_logs[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{out}")
        else:
            os.replace(tmp, targets[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return targets


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) for a source
    built in this process, or '' when its library was already built."""
    return _build_logs.get(name, "")


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (building every source first if
    needed), with argtypes and restype declared for each entry point."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            paths = build_all()
            for lib_name, path in paths.items():
                cdll = ctypes.CDLL(path)
                for fn, (restype, argtypes) in SIGNATURES[lib_name].items():
                    getattr(cdll, fn).restype = restype
                    getattr(cdll, fn).argtypes = argtypes
                _libs[lib_name] = cdll
        return _libs[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} "
                           f"({lib.vt_error_string(err).decode()})")
