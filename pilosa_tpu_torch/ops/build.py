"""Build and load the hand-written CUDA kernels (``ops/csrc/*.cu``).

Route (b) of the port's kernel rules: ``nvcc`` compiles each source into
its own shared library with a plain C interface, loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). The sources are
compiled for ``sm_90a`` (H100) at first use into the ignored build
directory ``pilosa_tpu_torch/_build/cuda/<digest>``, one ``nvcc``
process per source, all started together. The digest covers every
source and header and the flags, so an edited kernel rebuilds and an
unchanged one loads from the directory. ``load(csrc)`` builds and loads
the sources of another directory with the same C interface (an earlier
design, for an A/B on the card: ops/kernel_ab.py).

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
import time

from ..utils import build_dir

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = ("expr_count", "topn_block_count", "densify", "op_count",
           "expr_words")
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


def _digest(csrc: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(csrc)):
        with open(os.path.join(csrc, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def build(verbose: bool = False, csrc: str = CSRC) -> dict[str, str]:
    """Compile every source of ``csrc`` that has no library yet, in
    parallel; returns {source name: .so path}. ``verbose`` adds
    ``-Xptxas -v`` and prints the compiler's register/shared-memory
    report."""
    out_dir = build_dir("cuda", _digest(csrc))
    os.makedirs(out_dir, exist_ok=True)
    nvcc = nvcc_path()
    # An earlier design's directory (ops/kernel_ab.py) may lack a later
    # source: build what it has.
    paths = {name: os.path.join(out_dir, f"lib{name}.so")
             for name in SOURCES
             if os.path.exists(os.path.join(csrc, f"{name}.cu"))}
    procs = []
    for name, so in paths.items():
        if os.path.exists(so) and not verbose:
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, os.path.join(csrc, f"{name}.cu")]
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


# (library, C function, argument types) of every entry point.
def _signatures():
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    return (("expr_count", "pilosa_expr_count", [vp, vp, i, ll, ll, vp, vp]),
            ("expr_count", "pilosa_expr_count_batch",
             [vp, vp, vp, i, ll, ll, vp, vp]),
            ("expr_words", "pilosa_expr_words", [vp, vp, i, ll, ll, vp, vp]),
            ("expr_words", "pilosa_expr_fold_words",
             [vp, vp, i, i, ll, ll, vp, vp]),
            ("topn_block_count", "pilosa_topn_block_count",
             [vp, ll, ll, ll, vp, vp, i, vp, vp]),
            ("densify", "pilosa_densify", [vp, vp, ll, ll, ll, vp, vp]),
            ("op_count", "pilosa_op_count", [vp, vp, ll, ll, i, vp, vp]))


def _declare(libs: dict[str, ctypes.CDLL]) -> None:
    """Set each entry point's argument and return types (an earlier
    design's libraries may lack the later ones)."""
    for lib, name, argtypes in _signatures():
        fn = getattr(libs[lib], name, None) if lib in libs else None
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int


def load(csrc: str = CSRC) -> dict[str, ctypes.CDLL]:
    """Build (where needed) and load the libraries of ``csrc``."""
    libs = {name: ctypes.CDLL(path)
            for name, path in build(csrc=csrc).items()}
    _declare(libs)
    return libs


def libraries() -> dict[str, ctypes.CDLL]:
    """The loaded kernel libraries, building them on first call. That
    first load (and the nvcc build it may run) is charged as compile
    seconds to the query that paid for it (obs.accounting), under a
    ``kernel_build`` trace span."""
    global _libs
    with _mu:
        if _libs is None:
            from ..obs import accounting as obs_accounting
            from ..obs import trace as obs_trace
            t0 = time.perf_counter()
            with obs_trace.span_current("kernel_build"):
                _libs = load()
            obs_accounting.note_compile(time.perf_counter() - t0)
        return _libs
