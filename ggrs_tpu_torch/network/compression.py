"""Input compression: XOR delta against a reference input, then byte-level
RLE (the reference's `network/compression.py`, the pure-Python codec only:
the port has no native library to dispatch to).

Consecutive frames of input are usually near-identical, so XORing every
pending input against the last acked input yields mostly zero bytes, which
run-length encoding then collapses. The RLE container is a token stream of
LEB128 varints `v` where `v & 3` selects {0: literal bytes follow,
1: run of 0x00, 2: run of 0xFF} and `v >> 2` is the length — byte for byte
the reference's format, so either stack decodes the other's payloads.
"""

from __future__ import annotations

from typing import Iterable, List

from ..errors import DataFormatError


def _write_varint(out: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(buf: bytes, off: int) -> tuple[int, int]:
    shift = 0
    v = 0
    while True:
        if off >= len(buf):
            raise DataFormatError("truncated varint")
        b = buf[off]
        off += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, off
        shift += 7
        if shift > 35:
            raise DataFormatError("varint too long")


TOKEN_LITERAL = 0
TOKEN_ZEROS = 1
TOKEN_ONES = 2

# Runs shorter than this are cheaper inline as literals.
_MIN_RUN = 3


def rle_encode(data: bytes) -> bytes:
    """Collapse runs of 0x00 / 0xFF; everything else is literal."""
    out = bytearray()
    n = len(data)
    i = 0
    lit_start = 0

    def flush_literal(end: int) -> None:
        nonlocal lit_start
        while lit_start < end:
            chunk = min(end - lit_start, 1 << 20)
            _write_varint(out, (chunk << 2) | TOKEN_LITERAL)
            out.extend(data[lit_start : lit_start + chunk])
            lit_start += chunk

    while i < n:
        b = data[i]
        if b == 0x00 or b == 0xFF:
            j = i + 1
            while j < n and data[j] == b:
                j += 1
            run = j - i
            if run >= _MIN_RUN:
                flush_literal(i)
                token = TOKEN_ZEROS if b == 0x00 else TOKEN_ONES
                _write_varint(out, (run << 2) | token)
                i = j
                lit_start = i
                continue
            i = j
        else:
            i += 1
    flush_literal(n)
    return bytes(out)


# Decoded-output ceiling for untrusted streams: a few bytes of hostile RLE
# can claim a multi-gigabyte run (a decompression bomb), so decoding is
# always bounded. Protocol callers pass a tight wire-derived limit.
MAX_DECODE_OUTPUT = 1 << 26


def rle_decode(data: bytes, max_output: int = MAX_DECODE_OUTPUT) -> bytes:
    out = bytearray()
    off = 0
    while off < len(data):
        v, off = _read_varint(data, off)
        kind = v & 3
        length = v >> 2
        if len(out) + length > max_output:
            raise DataFormatError("decoded output exceeds limit")
        if kind == TOKEN_LITERAL:
            if off + length > len(data):
                raise DataFormatError("truncated literal run")
            out += data[off : off + length]
            off += length
        elif kind == TOKEN_ZEROS:
            out += b"\x00" * length
        elif kind == TOKEN_ONES:
            out += b"\xff" * length
        else:
            raise DataFormatError("invalid RLE token")
    return bytes(out)


def delta_encode(reference: bytes, pending: Iterable[bytes]) -> bytes:
    """XOR each pending input against the same reference."""
    out = bytearray()
    for inp in pending:
        assert len(inp) == len(reference), "input size mismatch"
        out += bytes(a ^ b for a, b in zip(reference, inp))
    return bytes(out)


def delta_decode(reference: bytes, data: bytes) -> List[bytes]:
    if len(reference) == 0 or len(data) % len(reference) != 0:
        raise DataFormatError(
            "delta payload not a multiple of the reference size"
        )
    out = []
    for i in range(0, len(data), len(reference)):
        chunk = data[i : i + len(reference)]
        out.append(bytes(a ^ b for a, b in zip(reference, chunk)))
    return out


def encode(reference: bytes, pending: Iterable[bytes]) -> bytes:
    """delta + RLE."""
    return rle_encode(delta_encode(reference, pending))


def decode(
    reference: bytes, data: bytes, max_output: int = MAX_DECODE_OUTPUT
) -> List[bytes]:
    """`max_output` bounds the decoded size — pass the largest legitimate
    payload when decoding wire data."""
    return delta_decode(reference, rle_decode(data, max_output))
