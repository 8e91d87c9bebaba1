"""Builder/loader for the real CPython extension (native/fastmutate.c).

Copy of the JAX package's ``storage/native_ext.py``. The per-op mutate
hot path needs a compiled crossing with no ctypes per-call floor: this
module compiles ``pilosa_tpu_torch/native/fastmutate.c`` against the
running interpreter's headers + numpy's C API on first use, into the
port's ignored build directory (``pilosa_tpu_torch/_build/host/<host>/``,
keyed by source hash and interpreter ABI, the scheme of
storage.native), and loads it as a genuine extension module.

No toolchain, no headers or a failed build fall back silently: the
pure-Python mutate paths are the permanent fallback (the extension
itself bails per-op on anything unusual, so both give the same bits).
Big-endian hosts never load it (the extension builds little-endian
wire records). The JAX package's ``PILOSA_TPU_NATIVE_EXT=0`` switch is
not carried over.

``EXT`` is the loaded module or None; the roaring hot paths read it as
one module-attribute load per op. ``load()`` triggers the build (called
from Fragment.open).
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                           "native")
_SRC = os.path.join(_NATIVE_DIR, "fastmutate.c")
_MOD_NAME = "pilosa_torch_fastmutate"

EXT = None
_tried = False
_lock = threading.Lock()


def _so_path() -> str:
    # Keyed by source hash + interpreter tag: the module links against
    # this exact CPython ABI, and -march=native makes it per-machine.
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    tag = sysconfig.get_config_var("SOABI") or "abi"
    from ..utils import build_dir
    cache = build_dir("host", os.uname().nodename)
    os.makedirs(cache, exist_ok=True)
    return os.path.join(cache, f"{_MOD_NAME}-{digest}-{tag}.so")


def _build(so: str) -> None:
    import numpy as np
    py_inc = sysconfig.get_paths()["include"]
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-march=native", "-shared", "-fPIC",
           "-I" + py_inc, "-I" + np.get_include(),
           "-o", tmp, _SRC]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, so)


def load():
    """Build (cached) + load the extension; returns the module or
    None. Idempotent and thread-safe; failures latch to None."""
    global EXT, _tried
    if _tried:
        return EXT
    with _lock:
        if _tried:
            return EXT
        try:
            if sys.byteorder != "little":
                EXT = None
            else:
                so = _so_path()
                if not os.path.exists(so):
                    _build(so)
                loader = importlib.machinery.ExtensionFileLoader(
                    _MOD_NAME, so)
                spec = importlib.util.spec_from_file_location(
                    _MOD_NAME, so, loader=loader)
                mod = importlib.util.module_from_spec(spec)
                loader.exec_module(mod)
                EXT = mod
        except Exception:  # noqa: BLE001 - the Python paths stand in
            EXT = None
        _tried = True
        return EXT
