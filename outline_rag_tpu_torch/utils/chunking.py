"""Document chunking for ingestion.

Capability parity with the reference chunking policy (reference
``app/rag.py:103-116,186-209``): recursive character splitting with a
separator hierarchy ``["\\n\\n", "\\n", " ", ""]``, chunk size 1024 chars with
100-char overlap, and the parent document title prepended to every chunk so
the embedded text carries document identity.

A C++ fast path (``outline_rag_tpu_torch/native``) is used automatically for large
corpora when the shared library has been built; this module is the reference
implementation and the fallback.
"""

from __future__ import annotations

import dataclasses
import os
from collections.abc import Sequence

DEFAULT_SEPARATORS: tuple[str, ...] = ("\n\n", "\n", " ", "")

# Documents below this size are not worth the ctypes round-trip.
_NATIVE_MIN_CHARS = 4096


@dataclasses.dataclass(frozen=True)
class Chunk:
    """One retrievable unit: the embedded text plus provenance."""

    text: str  # what gets embedded (title-prefixed)
    body: str  # raw chunk body without the title prefix
    start: int  # char offset of the body in the source document
    seq: int  # chunk ordinal within the document


def _split_on(text: str, separators: Sequence[str]) -> list[str]:
    """Split ``text`` by the first separator present, recursing on oversize
    pieces with the remaining separators."""
    if not separators:
        return [text]
    sep, rest = separators[0], separators[1:]
    if sep == "":
        return list(text)
    if sep not in text:
        return _split_on(text, rest)
    pieces = []
    for part in text.split(sep):
        pieces.append(part)
    # Re-attach the separator to the end of each piece except the last so
    # offsets and joins stay consistent.
    out: list[str] = []
    for i, p in enumerate(pieces):
        token = p + (sep if i < len(pieces) - 1 else "")
        if token:
            out.append(token)
    return out


def _recursive_pieces(text: str, chunk_size: int, separators: Sequence[str]) -> list[str]:
    pieces: list[str] = []
    for piece in _split_on(text, separators):
        if len(piece) <= chunk_size or len(separators) <= 1:
            if piece:
                pieces.append(piece)
        else:
            pieces.extend(_recursive_pieces(piece, chunk_size, separators[1:]))
    return pieces


def split_text(
    text: str,
    chunk_size: int = 1024,
    chunk_overlap: int = 100,
    separators: Sequence[str] = DEFAULT_SEPARATORS,
) -> list[str]:
    """Recursive character split: greedy merge of separator-delimited pieces
    into chunks of at most ``chunk_size`` chars with ``chunk_overlap`` chars
    of trailing context carried into the next chunk."""
    if chunk_overlap >= chunk_size:
        raise ValueError("chunk_overlap must be smaller than chunk_size")
    text = text.strip()
    if not text:
        return []
    if len(text) <= chunk_size:
        return [text]

    if (
        tuple(separators) == DEFAULT_SEPARATORS
        and len(text) >= _NATIVE_MIN_CHARS
        and os.environ.get("ORT_NATIVE", "1") != "0"
    ):
        from outline_rag_tpu_torch import native  # noqa: PLC0415

        result = native.chunk_text_native(text, chunk_size, chunk_overlap)
        if result is not None:
            return result

    pieces = _recursive_pieces(text, chunk_size, separators)
    chunks: list[str] = []
    cur: list[str] = []
    cur_len = 0
    for piece in pieces:
        if cur and cur_len + len(piece) > chunk_size:
            chunk = "".join(cur).strip()
            if chunk:
                chunks.append(chunk)
            # carry overlap: keep trailing pieces totalling <= chunk_overlap
            keep: list[str] = []
            keep_len = 0
            for p in reversed(cur):
                if keep_len + len(p) > chunk_overlap:
                    break
                keep.insert(0, p)
                keep_len += len(p)
            # the carried overlap plus the incoming piece must respect
            # chunk_size (reference pops leading pieces until it fits);
            # without this, overlap + a near-chunk_size piece emitted a
            # chunk up to chunk_size + chunk_overlap chars
            while keep and keep_len + len(piece) > chunk_size:
                keep_len -= len(keep[0])
                keep.pop(0)
            cur = keep
            cur_len = keep_len
        cur.append(piece)
        cur_len += len(piece)
    tail = "".join(cur).strip()
    if tail:
        chunks.append(tail)
    return chunks


def chunk_document(
    title: str,
    text: str,
    chunk_size: int = 1024,
    chunk_overlap: int = 100,
    separators: Sequence[str] = DEFAULT_SEPARATORS,
) -> list[Chunk]:
    """Split one document into title-prefixed chunks.

    The title prefix mirrors the reference's
    ``f"文档标题: {parent_title}\\n\\n{chunk}"`` injection (reference
    ``app/rag.py:203-204``) in an i18n-neutral form.
    """
    bodies = split_text(text, chunk_size, chunk_overlap, separators)
    chunks: list[Chunk] = []
    cursor = 0
    for seq, body in enumerate(bodies):
        start = text.find(body, cursor)
        if start < 0:
            start = cursor
        # advance PAST this occurrence: repeated identical bodies must
        # each find their own position, not all resolve to the first
        cursor = start + 1
        prefixed = f"Document title: {title}\n\n{body}" if title else body
        chunks.append(Chunk(text=prefixed, body=body, start=start, seq=seq))
    return chunks
