"""Pure-Python BLAKE3 — the portable correctness anchor.

BLAKE3 hash and keyed hash (with XOF output and incremental hashing
over the chunk-CV stack), copied from the JAX package. The native host hasher (``native/blake3.cc``), the plain torch
batch hasher (``ops/blake3.py``) and the CUDA kernel
(``csrc/blake3.cu``) are all validated against it; hot paths go through
:mod:`zest_tpu_torch.cas.hashing` instead.
"""

from __future__ import annotations

import struct

OUT_LEN = 32
KEY_LEN = 32
BLOCK_LEN = 64
CHUNK_LEN = 1024

CHUNK_START = 1 << 0
CHUNK_END = 1 << 1
PARENT = 1 << 2
ROOT = 1 << 3
KEYED_HASH = 1 << 4

IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

MSG_PERMUTATION = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

_MASK = 0xFFFFFFFF


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _MASK


def _g(state: list[int], a: int, b: int, c: int, d: int, mx: int, my: int) -> None:
    state[a] = (state[a] + state[b] + mx) & _MASK
    state[d] = _rotr(state[d] ^ state[a], 16)
    state[c] = (state[c] + state[d]) & _MASK
    state[b] = _rotr(state[b] ^ state[c], 12)
    state[a] = (state[a] + state[b] + my) & _MASK
    state[d] = _rotr(state[d] ^ state[a], 8)
    state[c] = (state[c] + state[d]) & _MASK
    state[b] = _rotr(state[b] ^ state[c], 7)


def _round(state: list[int], m: list[int]) -> None:
    # Columns.
    _g(state, 0, 4, 8, 12, m[0], m[1])
    _g(state, 1, 5, 9, 13, m[2], m[3])
    _g(state, 2, 6, 10, 14, m[4], m[5])
    _g(state, 3, 7, 11, 15, m[6], m[7])
    # Diagonals.
    _g(state, 0, 5, 10, 15, m[8], m[9])
    _g(state, 1, 6, 11, 12, m[10], m[11])
    _g(state, 2, 7, 8, 13, m[12], m[13])
    _g(state, 3, 4, 9, 14, m[14], m[15])


def compress(
    chaining_value: tuple[int, ...] | list[int],
    block_words: list[int],
    counter: int,
    block_len: int,
    flags: int,
) -> list[int]:
    """One BLAKE3 compression; returns the full 16-word output state."""
    state = [
        chaining_value[0], chaining_value[1], chaining_value[2], chaining_value[3],
        chaining_value[4], chaining_value[5], chaining_value[6], chaining_value[7],
        IV[0], IV[1], IV[2], IV[3],
        counter & _MASK, (counter >> 32) & _MASK, block_len, flags,
    ]
    m = list(block_words)
    for r in range(7):
        _round(state, m)
        if r < 6:
            m = [m[p] for p in MSG_PERMUTATION]
    for i in range(8):
        state[i] ^= state[i + 8]
        state[i + 8] ^= chaining_value[i]
    return state


def _words_from_block(block: bytes) -> list[int]:
    # Little-endian u32 words; callers zero-pad short blocks.
    if len(block) < BLOCK_LEN:
        block = block + b"\x00" * (BLOCK_LEN - len(block))
    return list(struct.unpack("<16I", block))


def _words_from_key(key: bytes) -> tuple[int, ...]:
    if len(key) != KEY_LEN:
        raise ValueError(f"key must be {KEY_LEN} bytes, got {len(key)}")
    return struct.unpack("<8I", key)


class _Output:
    """Deferred final compression — lets the root node emit arbitrary XOF length."""

    __slots__ = ("input_cv", "block_words", "counter", "block_len", "flags")

    def __init__(self, input_cv, block_words, counter, block_len, flags):
        self.input_cv = input_cv
        self.block_words = block_words
        self.counter = counter
        self.block_len = block_len
        self.flags = flags

    def chaining_value(self) -> list[int]:
        return compress(
            self.input_cv, self.block_words, self.counter, self.block_len, self.flags
        )[:8]

    def root_bytes(self, length: int) -> bytes:
        out = bytearray()
        counter = 0
        while len(out) < length:
            words = compress(
                self.input_cv, self.block_words, counter,
                self.block_len, self.flags | ROOT,
            )
            out += struct.pack("<16I", *words)
            counter += 1
        return bytes(out[:length])


class _ChunkState:
    __slots__ = ("cv", "counter", "block", "blocks_compressed", "flags")

    def __init__(self, key_words, counter: int, flags: int):
        self.cv = list(key_words)
        self.counter = counter
        self.block = bytearray()
        self.blocks_compressed = 0
        self.flags = flags

    def __len__(self) -> int:
        return BLOCK_LEN * self.blocks_compressed + len(self.block)

    def _start_flag(self) -> int:
        return CHUNK_START if self.blocks_compressed == 0 else 0

    def update(self, data: memoryview) -> None:
        pos = 0
        while pos < len(data):
            # Compress a buffered full block only when more input exists, so
            # the final block stays pending for CHUNK_END / ROOT flags.
            if len(self.block) == BLOCK_LEN:
                self.cv = compress(
                    self.cv, _words_from_block(bytes(self.block)),
                    self.counter, BLOCK_LEN, self.flags | self._start_flag(),
                )[:8]
                self.blocks_compressed += 1
                self.block.clear()
            take = min(BLOCK_LEN - len(self.block), len(data) - pos)
            self.block += data[pos : pos + take]
            pos += take

    def output(self) -> _Output:
        return _Output(
            self.cv, _words_from_block(bytes(self.block)), self.counter,
            len(self.block), self.flags | self._start_flag() | CHUNK_END,
        )


def _parent_output(left_cv, right_cv, key_words, flags: int) -> _Output:
    return _Output(key_words, list(left_cv) + list(right_cv), 0, BLOCK_LEN,
                   flags | PARENT)


class Hasher:
    """Incremental BLAKE3 hasher (hash and keyed modes)."""

    __slots__ = ("key_words", "flags", "cv_stack", "chunk")

    def __init__(self, key_words=None, flags: int = 0):
        self.key_words = tuple(key_words) if key_words is not None else IV
        self.flags = flags
        self.cv_stack: list[list[int]] = []
        self.chunk = _ChunkState(self.key_words, 0, flags)

    @classmethod
    def new_keyed(cls, key: bytes) -> "Hasher":
        return cls(_words_from_key(key), KEYED_HASH)

    def update(self, data: bytes | bytearray | memoryview) -> "Hasher":
        data = memoryview(data)
        pos = 0
        while pos < len(data):
            if len(self.chunk) == CHUNK_LEN:
                cv = self.chunk.output().chaining_value()
                total_chunks = self.chunk.counter + 1
                self._push_cv(cv, total_chunks)
                self.chunk = _ChunkState(self.key_words, total_chunks, self.flags)
            take = min(CHUNK_LEN - len(self.chunk), len(data) - pos)
            self.chunk.update(data[pos : pos + take])
            pos += take
        return self

    def _push_cv(self, cv: list[int], total_chunks: int) -> None:
        # Merge complete subtrees: one merge per trailing zero bit of the
        # total chunk count keeps the stack at O(log n).
        while total_chunks % 2 == 0:
            cv = _parent_output(
                self.cv_stack.pop(), cv, self.key_words, self.flags
            ).chaining_value()
            total_chunks //= 2
        self.cv_stack.append(cv)

    def _final_output(self) -> _Output:
        output = self.chunk.output()
        for cv in reversed(self.cv_stack):
            output = _parent_output(
                cv, output.chaining_value(), self.key_words, self.flags
            )
        return output

    def digest(self, length: int = OUT_LEN) -> bytes:
        return self._final_output().root_bytes(length)

    def hexdigest(self, length: int = OUT_LEN) -> str:
        return self.digest(length).hex()


# ── One-shot conveniences ──


def blake3(data: bytes, length: int = OUT_LEN) -> bytes:
    return Hasher().update(data).digest(length)


def blake3_keyed(key: bytes, data: bytes, length: int = OUT_LEN) -> bytes:
    return Hasher.new_keyed(key).update(data).digest(length)

