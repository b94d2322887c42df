"""ctypes bindings for the native C++ FASTA parser (native/fasta_native.cpp).

The reference's ingest is compiled Julia; the analog here is a small C++
library (zlib + tokenizer) loaded via ctypes — no pybind11 dependency.
The shared object is built lazily with g++ on first use, next to the
source; any failure (no compiler, no zlib, unreadable cache)
degrades silently to the pure-NumPy parser in io/fasta.py, which is also
the behavior under ``GDCA_NO_NATIVE=1``.

Parity between the two parsers is pinned by tests/test_native_io.py on
both bundled reference alignments and synthetic edge cases.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import List, Optional, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native",
    "fasta_native.cpp")
_SO_NAME = "_fasta_native.so"

_lock = threading.Lock()
_lib = None
_lib_path = None
_lib_failed = False


def _build(src: str, out: str) -> bool:
    # libdeflate inflates gzip ~2.3x faster than zlib and dominates
    # ingest wall; try linking it first, fall back to zlib-only where
    # it is absent (the source gates on GDCA_NO_LIBDEFLATE).
    cmds = (
        ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", src, "-lz",
         "-ldeflate", "-o", out],
        ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
         "-DGDCA_NO_LIBDEFLATE", src, "-lz", "-o", out],
    )
    for cmd in cmds:
        try:
            r = subprocess.run(cmd, capture_output=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired):
            return False
        if r.returncode == 0 and os.path.exists(out):
            return True
    return False


def _so_path(rebuild: bool = False) -> Optional[str]:
    """Locate or build the shared library next to its source (inside the
    checkout; ``*.so`` is in .gitignore); None if unavailable.
    ``rebuild`` ignores an existing build (one made on another machine
    may not load here)."""
    if not os.path.exists(_SRC):
        return None
    out = os.path.join(os.path.dirname(_SRC), _SO_NAME)
    if not rebuild and os.path.exists(out) and \
            os.path.getmtime(out) >= os.path.getmtime(_SRC):
        return out
    return out if _build(_SRC, out) else None


def _load():
    global _lib, _lib_path, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        if os.environ.get("GDCA_NO_NATIVE"):
            _lib_failed = True
            return None
        lib = None
        for rebuild in (False, True):
            path = _so_path(rebuild)
            if path is None:
                break
            try:
                lib = ctypes.CDLL(path)
                break
            except OSError:
                continue
        if lib is None:
            _lib_failed = True
            return None
        lib.gdca_parse.restype = ctypes.c_void_p
        lib.gdca_parse.argtypes = [ctypes.c_char_p, ctypes.c_double]
        lib.gdca_msa_error.restype = ctypes.c_char_p
        lib.gdca_msa_error.argtypes = [ctypes.c_void_p]
        for f in ("gdca_msa_m", "gdca_msa_n"):
            getattr(lib, f).restype = ctypes.c_int64
            getattr(lib, f).argtypes = [ctypes.c_void_p]
        for f in ("gdca_msa_q", "gdca_msa_dropped"):
            getattr(lib, f).restype = ctypes.c_int32
            getattr(lib, f).argtypes = [ctypes.c_void_p]
        lib.gdca_msa_tokens.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.gdca_msa_tokens.argtypes = [ctypes.c_void_p]
        lib.gdca_msa_header.restype = ctypes.c_char_p
        lib.gdca_msa_header.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        try:
            lib.gdca_msa_headers_blob.restype = ctypes.c_char_p
            lib.gdca_msa_headers_blob.argtypes = [ctypes.c_void_p]
        except AttributeError:   # stale cached .so without the symbol
            pass
        lib.gdca_msa_free.restype = None
        lib.gdca_msa_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        _lib_path = path
        return _lib


def available() -> bool:
    return _load() is not None


def backend() -> Optional[str]:
    """Which inflater the loaded library links: "libdeflate" or "zlib"
    (None when the native parser is unavailable). Read from the shared
    object's dynamic string table, so a cached build reports correctly."""
    if _load() is None:
        return None
    with open(_lib_path, "rb") as fh:
        return "libdeflate" if b"libdeflate.so" in fh.read() else "zlib"


def parse_fasta(path: str, max_gap_fraction: float
                ) -> Optional[Tuple[np.ndarray, List[str], int, int]]:
    """(tokens [M,N] uint8, headers, q, n_dropped) or None if the native
    library is unavailable. Raises ValueError on parse errors (same
    messages as the NumPy parser)."""
    lib = _load()
    if lib is None:
        return None
    # fsencode, not str.encode: surrogate-escaped (non-UTF-8) filesystem
    # paths must reach the C side as their original bytes
    h = lib.gdca_parse(os.fsencode(path), float(max_gap_fraction))
    if not h:
        return None
    try:
        err = lib.gdca_msa_error(h)
        if err:
            raise ValueError(err.decode())
        M = lib.gdca_msa_m(h)
        N = lib.gdca_msa_n(h)
        buf = ctypes.cast(lib.gdca_msa_tokens(h),
                          ctypes.POINTER(ctypes.c_uint8 * (M * N)))
        tokens = np.frombuffer(buf.contents, dtype=np.uint8).reshape(
            M, N).copy()
        headers = None
        if hasattr(lib, "gdca_msa_headers_blob"):
            blob = lib.gdca_msa_headers_blob(h)
            if blob is not None:
                # "replace", matching the NumPy parser: arbitrary header
                # bytes must not raise where the other parser succeeds
                parts = blob.decode("utf-8", "replace").split("\n")
                if len(parts) == M + 1 and parts[-1] == "":
                    headers = parts[:-1]
        if headers is None:   # NUL-truncated blob or legacy .so
            headers = [lib.gdca_msa_header(h, i).decode("utf-8", "replace")
                       for i in range(M)]
        q = int(lib.gdca_msa_q(h))
        dropped = int(lib.gdca_msa_dropped(h))
        return tokens, headers, q, dropped
    finally:
        lib.gdca_msa_free(h)
