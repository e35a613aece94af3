"""Build (and cache) the native host library `libdpqhost.so`.

The canonical build is CMake (see native/CMakeLists.txt); this module provides
the fast path used by tests and first import: a direct g++ invocation cached by
source digest, so `import duckdb_parquet_parser` works with zero setup.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path

_NATIVE_DIR = Path(__file__).resolve().parent / "native"
# inside the checkout (build/ is git-ignored); DPQ_BUILD_CACHE overrides
_DEFAULT_CACHE = Path(__file__).resolve().parents[2] / "build" / "native"

_lock = threading.Lock()
_cached_path: Path | None = None

_LIB_DIRS = [
    Path("/usr/lib/x86_64-linux-gnu"),
    Path("/usr/lib/aarch64-linux-gnu"),
    Path("/usr/lib64"),
    Path("/usr/lib"),
    Path("/usr/local/lib"),
]


def _find_lib(*patterns: str) -> Path | None:
    for d in _LIB_DIRS:
        if not d.is_dir():
            continue
        for pat in patterns:
            hits = sorted(d.glob(pat))
            if hits:
                return hits[0]
    return None


def _codec_flags() -> list[str]:
    """Compile defines + link args for the optional page codecs.

    zlib/zstd ship dev headers in this image; lz4/brotli ship only the
    runtime .so.1 (prototypes are declared in dpq_codec.hpp), so those are
    linked by full path.  Missing libraries simply drop the codec —
    dpq_codec.hpp gates each on its DPQ_HAVE_* define.
    """
    flags: list[str] = []
    inc = Path("/usr/include")
    z = _find_lib("libz.so", "libz.so.*")
    if (inc / "zlib.h").exists() and z is not None:
        flags += ["-DDPQ_HAVE_ZLIB", str(z)]
    zstd = _find_lib("libzstd.so", "libzstd.so.*")
    if (inc / "zstd.h").exists() and zstd is not None:
        flags += ["-DDPQ_HAVE_ZSTD", str(zstd)]
    lz4 = _find_lib("liblz4.so", "liblz4.so.*")
    if lz4 is not None:
        flags += ["-DDPQ_HAVE_LZ4", str(lz4)]
    bdec = _find_lib("libbrotlidec.so", "libbrotlidec.so.*")
    benc = _find_lib("libbrotlienc.so", "libbrotlienc.so.*")
    if bdec is not None and benc is not None:
        flags += ["-DDPQ_HAVE_BROTLI", str(bdec), str(benc)]
    return flags


def _digest(extra: list[str]) -> str:
    h = hashlib.sha256()
    for path in sorted(_NATIVE_DIR.glob("*.hpp")) + sorted(
        _NATIVE_DIR.glob("*.cpp")
    ):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update("\0".join(extra).encode())
    return h.hexdigest()[:16]


def build_library(force: bool = False, sanitize: bool = False) -> Path:
    """Compile libdpqhost.so if needed; returns the cached .so path."""
    global _cached_path
    with _lock:
        if _cached_path is not None and not force:
            return _cached_path
        cache_dir = Path(os.environ.get("DPQ_BUILD_CACHE", _DEFAULT_CACHE))
        cache_dir.mkdir(parents=True, exist_ok=True)
        codec_flags = _codec_flags()
        cxx = os.environ.get("CXX", "g++")
        if sanitize:
            mode = ["-g", "-fsanitize=address,undefined"]
        else:
            # the C++ runtime goes into the library, its symbols kept local:
            # the process has already loaded the system libstdc++, which
            # need not match the one of the compiler in CXX
            mode = ["-static-libstdc++", "-static-libgcc",
                    "-Wl,--exclude-libs,ALL"]
        tag = _digest(codec_flags + mode + ["-march=native", cxx]) + (
            "-asan" if sanitize else "")
        so_path = cache_dir / f"libdpqhost-{tag}.so"
        if not so_path.exists() or force:
            # per-process temp name: concurrent test workers may build at once
            tmp = so_path.with_suffix(f".so.{os.getpid()}.tmp")
            cmd = [
                cxx,
                "-std=c++17",
                "-O3",
                *mode,
                # the library is compiled on the machine that runs it (cached
                # per source digest), so tuning for the local ISA is safe —
                # the value walks vectorize with AVX2 where available
                "-march=native",
                "-fPIC",
                "-shared",
                "-pthread",
                "-Wall",
                "-Wextra",
                str(_NATIVE_DIR / "dpq_capi.cpp"),
                *codec_flags,
                "-o",
                str(tmp),
            ]
            subprocess.run(cmd, check=True, capture_output=True, text=True)
            os.replace(tmp, so_path)
        _cached_path = so_path
        return so_path
