"""Key digitization: byte-string keys -> fixed-width uint32 word vectors.

A key of <= 4*KW bytes becomes KW big-endian uint32 words (zero padded) plus
a length word; lexicographic order on (words msw-first..., length) equals
bytewise order on the original keys (zero-padded prefixes compare equal on
words, and the genuinely shorter key sorts first via the length word —
matching e.g. b"a" < b"a\\x00").  Keys longer than 4*KW bytes cannot be
represented exactly.

Word layout: index 0 is the MOST significant word; the length word is last
(the least significant tie-break).  Host arrays are row-major
[N, key_words+1]; the engine transposes to word-major [key_words+1, N].

Device word encoding.  PyTorch's uint32 lacks ordered comparisons and
arithmetic, so on the device every key word is an int32 holding the uint32
word with its sign bit flipped (``w ^ 0x80000000``): signed order on the
flipped word equals unsigned order on the original, and ``INF_WORD``
(0xFFFFFFFF) becomes ``INT32_MAX``, which still sorts last.  The flip
happens at the two host boundaries only — the batch blob and the carried
state — via ``to_device_words`` / ``from_device_words`` (numpy) and
``flip_words`` (tensors).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..flow.hotpath import hot_path

# Sentinel "plus infinity" key (greater than any real key: real length word
# is < 2**31 and the sentinel is the max uint32).
INF_WORD = np.uint32(0xFFFFFFFF)

SIGN_BIT = -(2**31)  # int32 bit pattern 0x80000000
INF_DEV = 2**31 - 1  # INF_WORD in the device encoding
ZERO_DEV = -(2**31)  # word 0 in the device encoding


@hot_path(bound="batch")
def encode_keys(keys: Sequence[bytes], key_words: int) -> np.ndarray:
    """[N, key_words+1] uint32; words most-significant-FIRST, length last."""
    width = key_words * 4
    n = len(keys)
    out = np.zeros((n, key_words + 1), dtype=np.uint32)  # perfcheck: ignore[HOT003]: result is returned to and retained by the caller, so it cannot ride the staging ring
    if n == 0:
        return out
    lens = np.fromiter((len(k) for k in keys), np.int64, count=n)
    if int(lens.max()) > width:
        raise ValueError(
            f"key longer than {width} bytes cannot be digitized at "
            f"key_words={key_words}; route to the CPU engine"
        )
    # Bulk pad: scatter the concatenated bytes into a zeroed [n, width]
    # buffer at vectorized positions instead of n ljust'ed copies.
    flat = np.frombuffer(b"".join(keys), np.uint8)  # perfcheck: ignore[HOT003]: zero-copy view over the joined bytes, no buffer is allocated
    buf = np.zeros(n * width, np.uint8)  # perfcheck: ignore[HOT003]: uint8 scatter scratch the engine's uint32 blob ring (_StagingRing) cannot serve; one zeroed buffer replaces n per-key ljust copies
    starts = np.zeros(n, np.int64)  # perfcheck: ignore[HOT003]: int64 cumsum scratch; the engine's uint32 blob ring (_StagingRing) cannot serve it and zeroing seeds starts[0]
    np.cumsum(lens[:-1], out=starts[1:])
    pos = (
        np.arange(flat.size, dtype=np.int64)
        + np.repeat(np.arange(n, dtype=np.int64) * width - starts, lens)
    )
    buf[pos] = flat
    out[:, :key_words] = buf.view(">u4").reshape(n, key_words)
    out[:, key_words] = lens.astype(np.uint32)
    return out


def encode_int_keys(ints: np.ndarray, key_words: int, byte_len: int = 8) -> np.ndarray:
    """Fast path for integer-derived keys (big-endian byte_len-byte keys).

    Equivalent to encode_keys([i.to_bytes(byte_len, 'big') for i in ints]).
    """
    assert byte_len <= 8 and byte_len <= key_words * 4
    n = len(ints)
    out = np.zeros((n, key_words + 1), dtype=np.uint32)
    v = ints.astype(np.uint64)
    shifted = v << np.uint64(8 * (8 - byte_len))  # left-align in 8 bytes
    out[:, 0] = (shifted >> np.uint64(32)).astype(np.uint32)
    if key_words >= 2:
        out[:, 1] = (shifted & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out[:, key_words] = byte_len
    return out


def fits(keys: Sequence[bytes], key_words: int) -> bool:
    """Every key is representable at key_words (at most 4*key_words bytes)."""
    width = key_words * 4
    return all(len(k) <= width for k in keys)


def uniform_int_split_keys(n_shards: int, max_key: int, byte_len: int = 8) -> List[bytes]:
    """n_shards - 1 split points dividing the big-endian byte_len-byte
    integer keys in [0, max_key) evenly."""
    return [(max_key * s // n_shards).to_bytes(byte_len, "big") for s in range(1, n_shards)]


def decode_key(row: np.ndarray, key_words: int) -> bytes:
    length = int(row[key_words])
    if length == int(INF_WORD):
        return b"\xff" * (key_words * 4 + 1)  # sentinel, cannot round-trip
    words = row[:key_words].astype(">u4")
    return words.tobytes()[:length]


def decode_keys(rows: np.ndarray, key_words: int) -> list:
    """Bulk inverse of encode_keys for real keys (no INF sentinels): one
    byte round-trip of the word block plus a per-row length slice."""
    n = len(rows)
    if n == 0:
        return []
    width = key_words * 4
    raw = np.ascontiguousarray(rows[:, :key_words]).astype(">u4").tobytes()
    lens = rows[:, key_words].tolist()
    mv = memoryview(raw)
    return [bytes(mv[i * width : i * width + lens[i]]) for i in range(n)]


def to_device_words(words_u32: np.ndarray) -> np.ndarray:
    """uint32 key words -> the device encoding (int32, sign bit flipped)."""
    return (np.asarray(words_u32, np.uint32) ^ np.uint32(0x80000000)).view(np.int32)


def from_device_words(words_i32: np.ndarray) -> np.ndarray:
    """Inverse of to_device_words."""
    return np.asarray(words_i32, np.int32).view(np.uint32) ^ np.uint32(0x80000000)


def flip_words(t: torch.Tensor) -> torch.Tensor:
    """Tensor twin of to_device_words / from_device_words on int32 bit
    patterns (the flip is its own inverse)."""
    return t ^ SIGN_BIT
