"""Build and load the CUDA kernels in `csrc/`.

Every `csrc/*.cu` file is compiled by its own `nvcc` process, all started
together, into an object file; one more `nvcc` call links them into a
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds). The library is placed under
`build/storygen_tpu_torch/<hash>/` at the repository root, keyed by a hash
of the flags, the sources and the `csrc/*.cuh` headers they include, and
loaded with `ctypes`; every pointer and the
stream are passed as `c_void_p`. The build runs at the first kernel launch,
never at import. A missing `nvcc` or a failed build raises. Each source's
`ptxas -v` report (registers, stack and spill bytes of every kernel) is
kept beside the library as `<stem>.ptxas.txt` (`ptxas_report`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "storygen_tpu_torch"
LIB_NAME = "libstorygen_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
# the library build's own: ptxas reports every kernel's registers and spills
REPORT_FLAGS = ("-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signature of every exported launcher; each returns a cudaError_t.
# `keep` is a (B, nref) int32 table or NULL, `span` the kv rows per ref.
SIGNATURES = {
    # q, k, v, o, B, H, Sq, Skv, D, q/k/v batch and row strides,
    # keep, nref, span, scale, stream
    "sg_flash_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                     _L, _L, _L, _L, _L, _L, _P, _I, _I, _F, _P),
    # q, k, lse, B, H, Sq, Skv, D, q/k strides, keep, nref, span, scale,
    # stream
    "sg_flash_lse": (_P, _P, _P, _I, _I, _I, _I, _I,
                     _L, _L, _L, _L, _P, _I, _I, _F, _P),
    # q, k, v, dout, lse, delta, dq, B, H, Sq, Skv, D, q/k/v strides,
    # keep, nref, span, scale, stream
    "sg_flash_dq": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                    _L, _L, _L, _L, _L, _L, _P, _I, _I, _F, _P),
    # q, k, v, dout, lse, delta, dk, dv, then as sg_flash_dq
    "sg_flash_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                     _L, _L, _L, _L, _L, _L, _P, _I, _I, _F, _P),
    # proj, w, bias, bias is fp32, out, M, N, E, rows per image, stream
    "sg_geglu_matmul": (_P, _P, _P, _I, _P, _I, _I, _I, _I, _P),
    # x, w9, bias, bias batch stride, residual, out, split workspace,
    # splits, B, H, W, Cin, Cout, stream
    "sg_conv3x3": (_P, _P, _P, _L, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, w9, bias, bias batch stride, a, s, residual, out, split workspace,
    # splits, B, H, W, Cin, Cout, stream
    "sg_gnconv3x3": (_P, _P, _P, _L, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                     _I, _P),
    # x, w9, bias, out, split workspace, splits, B, H, W, Cin, Cout, Ho,
    # Wo, pad top, pad left, stream
    "sg_downconv3x3": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                       _I, _I, _P),
    # x, w16, bias, out, split workspace, splits, B, H, W, Cin, Cout (the
    # source's size), stream
    "sg_upconv3x3": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # the attention studies (ops/study_attention.py, ops/study_int8.py):
    # q, k, v, out, BH, Sq, Skv, d, mode, bq, bk, halves, scale, stream
    "sg_study_online": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                        _P),
    # q, k, v, bound, out, BH, Sq, Skv, W, d, kind, bq, bk, sub, halves, g,
    # guard, stream
    "sg_study_bounded": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _F, _P),
    # the same for S2's BND2 instantiations (csrc/study_bnd2.cu)
    "sg_study_bnd2": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                      _I, _I, _I, _F, _P),
    # q_t, k, out, BH, Sq, Skv, D, k's map width, k's batch and row
    # strides, int8, bq, bk, stream
    "sg_study_qk": (_P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _I, _I, _I,
                    _P),
    # q8, k8, v_ext, sq, sk, bnd, out, BH, Sq, Skv, D, bq, bk, stream
    "sg_study_int8": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> List[Path]:
    """The headers the sources include (`#include "x.cuh"`)."""
    return sorted(CSRC.glob("*.cuh"))


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def source_hash(srcs: List[Path]) -> str:
    """Hash of the flags, the sources and every shared header, so that
    editing a header rebuilds the library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + REPORT_FLAGS).encode())
    for p in list(srcs) + headers():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def lib_path(srcs: List[Path]) -> Path:
    return BUILD_ROOT / source_hash(srcs) / LIB_NAME


def compile_command(nvcc: str, src: Path, obj: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, *REPORT_FLAGS, "-c", "-o", str(obj), str(src)]


def ptxas_report(stem: str) -> str:
    """The `ptxas -v` output of csrc/<stem>.cu in this tree's build (after
    `load()`)."""
    return lib_path(sources()).with_name(f"{stem}.ptxas.txt").read_text()


def link_command(nvcc: str, objs: List[Path], out: Path) -> List[str]:
    return [nvcc, "-shared", "-o", str(out), *map(str, objs)]


def _run_all(cmds: List[List[str]]) -> List[str]:
    """Run the commands in parallel; raise with the failures' output once
    all have ended, else return each command's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        outs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        srcs = sources()
        out = lib_path(srcs)
        if not out.exists():
            import time
            out.parent.mkdir(parents=True, exist_ok=True)
            nvcc = find_nvcc()
            tag = f"{os.getpid()}.tmp"
            objs = [out.with_name(f"{s.stem}.{tag}.o") for s in srcs]
            tmp = out.with_name(f"{LIB_NAME}.{tag}")
            t0 = time.perf_counter()
            reports = _run_all([compile_command(nvcc, s, o)
                                for s, o in zip(srcs, objs)])
            _run_all([link_command(nvcc, objs, tmp)])
            for s, text in zip(srcs, reports):
                out.with_name(f"{s.stem}.ptxas.txt").write_text(text)
            os.replace(tmp, out)
            for o in objs:
                o.unlink()
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(out))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{name} failed with cudaError_t {err}")
