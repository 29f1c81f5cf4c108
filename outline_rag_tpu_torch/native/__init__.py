"""Native (C++) components, loaded via ctypes.

``libortnative.so`` currently provides the ingestion chunker hot loop
(``chunker.cc``). The library auto-builds on first use when a toolchain is
available (``make`` in this directory); all callers fall back to the pure
Python implementations when the library is absent, so the framework has no
hard native dependency.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

log = logging.getLogger(__name__)

_HERE = os.path.dirname(__file__)
_SO = os.path.join(_HERE, "build", "libortnative.so")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-s"], cwd=_HERE, check=True, capture_output=True, timeout=120
        )
        return os.path.exists(_SO)
    except Exception as exc:
        log.info("native build unavailable (%s); using Python fallbacks", exc)
        return False


def load() -> ctypes.CDLL | None:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) and not _build():
            return None
        try:
            lib = ctypes.CDLL(_SO)
            lib.ort_chunk_text.restype = ctypes.c_int
            lib.ort_chunk_text.argtypes = [
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
                ctypes.c_int,
            ]
            lib.ort_parse_request_head.restype = ctypes.c_int
            lib.ort_parse_request_head.argtypes = [
                ctypes.c_char_p,  # buf
                ctypes.c_int,  # len
                ctypes.POINTER(_Span),  # method
                ctypes.POINTER(_Span),  # target
                ctypes.POINTER(_Span),  # version
                ctypes.POINTER(_Span),  # names
                ctypes.POINTER(_Span),  # values
                ctypes.c_int,  # max_headers
                ctypes.POINTER(ctypes.c_int),  # n_headers
                ctypes.c_char_p,  # lowered scratch
            ]
            _lib = lib
        except (OSError, AttributeError) as exc:
            log.warning("failed to load native library: %s", exc)
        return _lib


class _Span(ctypes.Structure):
    _fields_ = [("off", ctypes.c_int), ("len", ctypes.c_int)]


_MAX_HEADERS = 128


def parse_request_head_native(
    head: bytes,
) -> tuple[str, str, dict[str, str]] | None:
    """Parse an HTTP/1.1 request head (through the terminating blank
    line) into (method, target, lower-cased header dict) — the
    uvloop/httptools-equivalent native transport piece (SURVEY.md
    section 2b). Returns None when the library is unavailable or the
    head is malformed/incomplete (caller falls back to Python parsing).
    """
    lib = load()
    if lib is None:
        return None
    n = len(head)
    method, target, version = _Span(), _Span(), _Span()
    names = (_Span * _MAX_HEADERS)()
    values = (_Span * _MAX_HEADERS)()
    n_headers = ctypes.c_int(0)
    lowered = ctypes.create_string_buffer(n or 1)
    rc = lib.ort_parse_request_head(
        head, n, ctypes.byref(method), ctypes.byref(target),
        ctypes.byref(version), names, values, _MAX_HEADERS,
        ctypes.byref(n_headers), lowered,
    )
    if rc <= 0:
        return None
    low = lowered.raw
    headers: dict[str, str] = {}
    for i in range(n_headers.value):
        nm = low[names[i].off : names[i].off + names[i].len]
        val = head[values[i].off : values[i].off + values[i].len]
        headers[nm.decode("latin1")] = val.decode("latin1")
    return (
        head[: method.len].decode("latin1"),
        head[target.off : target.off + target.len].decode("latin1"),
        headers,
    )


def chunk_text_native(
    text: str, chunk_size: int, chunk_overlap: int
) -> list[str] | None:
    """Native split_text; None when the library is unavailable (caller
    falls back to Python)."""
    lib = load()
    if lib is None:
        return None
    try:
        data = text.encode("utf-32-le")
    except UnicodeEncodeError:
        # lone surrogates (e.g. unpaired \ud800 escapes surviving
        # json.loads) cannot round-trip UTF-32 — fall back to Python,
        # which handles them fine
        return None
    n = len(data) // 4
    buf = (ctypes.c_uint32 * n).from_buffer_copy(data) if n else (ctypes.c_uint32 * 1)()
    max_chunks = max(16, 4 * (n // max(1, chunk_size - chunk_overlap)) + 16)
    out_off = (ctypes.c_int * max_chunks)()
    out_len = (ctypes.c_int * max_chunks)()
    count = lib.ort_chunk_text(
        buf, n, chunk_size, chunk_overlap, out_off, out_len, max_chunks
    )
    if count < 0:
        return None
    return [text[out_off[i] : out_off[i] + out_len[i]] for i in range(count)]
