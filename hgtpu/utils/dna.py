"""DNA sequence encoding utilities.

Device-first convention: bases are int8 codes A=0 C=1 G=2 T=3, N=4; '.' (gap /
deleted) = 5.  All device-side sequence arrays use this encoding so that
complement is ``3 - code`` and 2-bit packing is ``code & 3``.
"""
from __future__ import annotations

import numpy as np

BASES = "ACGTN."

_ENC = np.full(256, 4, dtype=np.int8)
for _i, _c in enumerate(BASES):
    _ENC[ord(_c)] = _i
    _ENC[ord(_c.lower())] = _i

_COMP = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N", ".": "."}


def encode_seq(seq: str) -> np.ndarray:
    """Encode an ASCII DNA string into int8 codes."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _ENC[raw]


_DEC_TABLE = bytes(
    BASES[i].encode("ascii")[0] if i < len(BASES) else ord("N")
    for i in range(256))


def decode_seq(codes: np.ndarray) -> str:
    # bytes.translate over the raw int8 buffer: one C call, no gather
    return np.ascontiguousarray(codes, dtype=np.int8).tobytes() \
        .translate(_DEC_TABLE).decode("ascii")


def revcomp(seq: str) -> str:
    return "".join(_COMP.get(c, c) for c in reversed(seq))


def revcomp_encoded(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of int8-encoded codes (N and '.' map to themselves)."""
    out = codes[::-1].copy()
    acgt = out < 4
    out[acgt] = 3 - out[acgt]
    return out
