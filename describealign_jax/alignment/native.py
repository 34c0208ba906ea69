"""Lazy builder/loader for the native host DP library (C++).

The irregular dynamic programs (weighted LIS, pass-2 refinement DP) are
host-side and latency-critical; they are implemented in C++
(describealign_jax/native/dp.cpp) and loaded via ctypes. The library is
compiled on first use with g++ and cached next to the source. If no
compiler is available the callers fall back to the Python implementations.
"""
import ctypes
import os
import subprocess
import threading

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_SRC_DIR = os.path.join(os.path.dirname(__file__), '..', 'native')
_SRCS = [os.path.abspath(os.path.join(_SRC_DIR, f))
         for f in ('dp.cpp', 'features.cpp')]
_SRC = _SRCS[0]
_OUT = os.path.abspath(os.path.join(_SRC_DIR, 'libdadp.so'))


def _host_fingerprint():
    """Identifies the CPU the library was built for. -march=native code
    must never run on a different host (SIGILL), so the .so is gitignored
    AND invalidated when the fingerprint changes (VM migrations)."""
    import hashlib
    import platform
    ident = platform.machine()
    try:
        with open('/proc/cpuinfo') as f:
            for line in f:
                if line.startswith(('flags', 'Features')):
                    ident += line
                    break
    except OSError:
        ident += platform.processor()
    return hashlib.sha1(ident.encode()).hexdigest()[:16]


def _build():
    # -march=native: the library is compiled lazily on the machine that
    # runs it, so host-specific SIMD is safe (and load-bearing for the
    # feature extractor's throughput)
    cmd = (['g++', '-O3', '-march=native', '-shared', '-fPIC', '-std=c++17']
           + _SRCS + ['-o', _OUT])
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except subprocess.CalledProcessError:
        # portable fallback (older g++ / unsupported -march)
        cmd = (['g++', '-O3', '-shared', '-fPIC', '-std=c++17']
               + _SRCS + ['-o', _OUT])
        subprocess.run(cmd, check=True, capture_output=True)
    with open(_OUT + '.buildinfo', 'w') as f:
        f.write(_host_fingerprint())


def native_lib():
    """Return the loaded ctypes library, or None if unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get('DESCRIBEALIGN_NO_NATIVE'):
            return None
        try:
            if not all(os.path.exists(s) for s in _SRCS):
                return None
            stale = (not os.path.exists(_OUT)
                     or any(os.path.getmtime(_OUT) < os.path.getmtime(s)
                            for s in _SRCS))
            try:
                with open(_OUT + '.buildinfo') as f:
                    stale = stale or f.read() != _host_fingerprint()
            except OSError:
                stale = True    # no provenance: never trust the binary
            if stale:
                _build()
            lib = ctypes.CDLL(_OUT)
            lib.weighted_lis.restype = ctypes.c_int
            lib.lis_from_match.restype = ctypes.c_int
            lib.lis_stream_new.restype = ctypes.c_void_p
            lib.lis_stream_new.argtypes = [ctypes.c_longlong]
            lib.lis_stream_free.restype = None
            lib.lis_stream_free.argtypes = [ctypes.c_void_p]
            lib.lis_stream_feed.restype = ctypes.c_int
            lib.lis_stream_feed_u8.restype = ctypes.c_int
            lib.lis_stream_feed_split.restype = ctypes.c_int
            lib.lis_stream_feed_packed.restype = ctypes.c_int
            lib.lis_stream_feed_packed_strided.restype = ctypes.c_int
            lib.lis_stream_feed_compact.restype = ctypes.c_int
            lib.lis_stream_count.restype = ctypes.c_longlong
            lib.lis_stream_count.argtypes = [ctypes.c_void_p]
            lib.lis_stream_finish.restype = ctypes.c_int
            lib.refine_dp.restype = ctypes.c_int
            lib.refine_score_cluster.restype = ctypes.c_int
            lib.refine_offset_stats.restype = ctypes.c_int
            lib.tv1d_weighted.restype = ctypes.c_int
            lib.extract_features_i16.restype = ctypes.c_int
            lib.conv_f64.restype = ctypes.c_int
            lib.continuity_filter_f64.restype = ctypes.c_int
            lib.round_decimals6_f64.restype = ctypes.c_int
            lib.pv_phase_lock.restype = ctypes.c_int
            lib.pv_phase_lock_carry.restype = ctypes.c_int
            lib.resample_quad.restype = ctypes.c_int
            _LIB = lib
        except Exception:
            _LIB = None
        return _LIB
