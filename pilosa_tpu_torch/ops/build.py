"""Build and load the hand-written CUDA kernels (``ops/csrc/*.cu``).

Route (b) of the port's kernel rules: ``nvcc`` compiles each source into
its own shared library with a plain C interface, loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). The sources are
compiled for ``sm_90a`` (H100) at first use into the ignored build
directory ``pilosa_tpu_torch/_build/cuda/<digest>``, one ``nvcc``
process per source, all started together. The digest covers every
source and header and the flags, so an edited kernel rebuilds and an
unchanged one loads from the directory.

Nothing here runs at import: ``libraries()`` is called by the kernel
wrappers (ops.cuda_kernels) when they first launch on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from ..utils import build_dir

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = ("expr_count", "topn_block_count", "densify", "op_count")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] | None = None
_mu = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME or
    /usr/local/cuda. Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH, CUDA_HOME or /usr/local/cuda)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> dict[str, str]:
    """Compile every source that has no library yet, in parallel;
    returns {source name: .so path}. ``verbose`` adds ``-Xptxas -v``
    and prints the compiler's register/shared-memory report."""
    out_dir = build_dir("cuda", _digest())
    os.makedirs(out_dir, exist_ok=True)
    nvcc = nvcc_path()
    paths = {name: os.path.join(out_dir, f"lib{name}.so")
             for name in SOURCES}
    procs = []
    for name, so in paths.items():
        if os.path.exists(so) and not verbose:
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, so, tmp, proc in procs:
        log, _ = proc.communicate()
        if verbose:
            print(f"[nvcc {name}]\n{log.decode(errors='replace')}",
                  flush=True)
        if proc.returncode != 0:
            failed.append(f"{name}: {log.decode(errors='replace')}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def _declare(libs: dict[str, ctypes.CDLL]) -> None:
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = libs["expr_count"].pilosa_expr_count
    fn.argtypes = [vp, vp, i, ll, ll, vp, vp]
    fn.restype = i
    fn = libs["topn_block_count"].pilosa_topn_block_count
    fn.argtypes = [vp, ll, ll, ll, vp, vp, i, vp, vp]
    fn.restype = i
    fn = libs["densify"].pilosa_densify
    fn.argtypes = [vp, vp, ll, ll, ll, vp, vp]
    fn.restype = i
    fn = libs["op_count"].pilosa_op_count
    fn.argtypes = [vp, vp, ll, ll, i, vp, vp]
    fn.restype = i


def libraries() -> dict[str, ctypes.CDLL]:
    """The loaded kernel libraries, building them on first call."""
    global _libs
    with _mu:
        if _libs is None:
            libs = {name: ctypes.CDLL(path)
                    for name, path in build().items()}
            _declare(libs)
            _libs = libs
        return _libs
