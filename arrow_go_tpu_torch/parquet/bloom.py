"""Split-block bloom filters of parquet column chunks.

Port of arrow_go_tpu/parquet/bloom.py (reference
parquet/metadata/bloom_filter.go, bloom_filter_block.go): blocks of
eight 32-bit words, each value setting one bit per word picked by its
salted hash, values hashed as XXH64 (seed 0) of their PLAIN bytes. The
hash runs in the port's host codec library (native.py); a batch of
values hashes and inserts in one call each, numpy over the block math.
"""
from __future__ import annotations

import math
import struct

import numpy as np

from .. import native
from . import format as fmt
from .thrift import CompactReader, CompactWriter, ThriftStruct

SALT = np.array([0x47b6137b, 0x44974d91, 0x8824ad5b, 0xa2b7289d,
                 0x705495c7, 0x2df1424b, 0x9efc4947, 0x5c6bfb31],
                dtype=np.uint32)

BYTES_PER_BLOCK = 32  # 8 words x 32 bits


class SplitBlockAlgorithm(ThriftStruct):
    FIELDS = {}


class BloomFilterAlgorithm(ThriftStruct):
    FIELDS = {1: ("BLOCK", SplitBlockAlgorithm)}


class XxHash(ThriftStruct):
    FIELDS = {}


class BloomFilterHash(ThriftStruct):
    FIELDS = {1: ("XXHASH", XxHash)}


class Uncompressed(ThriftStruct):
    FIELDS = {}


class BloomFilterCompression(ThriftStruct):
    FIELDS = {1: ("UNCOMPRESSED", Uncompressed)}


class BloomFilterHeader(ThriftStruct):
    FIELDS = {1: ("numBytes", "i32"),
              2: ("algorithm", BloomFilterAlgorithm),
              3: ("hash", BloomFilterHash),
              4: ("compression", BloomFilterCompression)}


def optimal_num_blocks(ndv: int, fpp: float = 0.01) -> int:
    """Blocks for `ndv` distinct values at false-positive rate `fpp`,
    rounded up to a power of two (reference bloom_filter.go sizing)."""
    if ndv <= 0:
        return 1
    bits = -8 * ndv / math.log(1 - fpp ** 0.125)
    blocks = max(int(bits) // 256 + 1, 1)
    return 1 << (blocks - 1).bit_length()


_PACK = {fmt.Type.INT32: "<i4", fmt.Type.INT64: "<i8",
         fmt.Type.FLOAT: "<f4", fmt.Type.DOUBLE: "<f8"}


def _value_bytes(v, phys: fmt.Type) -> bytes:
    """The PLAIN bytes of one value, as the JAX package's _hash_value
    packs them."""
    if phys == fmt.Type.INT32:
        return struct.pack("<i", int(v))
    if phys == fmt.Type.INT64:
        return struct.pack("<q", int(v))
    if phys == fmt.Type.FLOAT:
        return struct.pack("<f", float(v))
    if phys == fmt.Type.DOUBLE:
        return struct.pack("<d", float(v))
    if phys in (fmt.Type.BYTE_ARRAY, fmt.Type.FIXED_LEN_BYTE_ARRAY):
        return v.encode() if isinstance(v, str) else bytes(v)
    if phys == fmt.Type.BOOLEAN:
        return b"\x01" if v else b"\x00"
    raise NotImplementedError(f"bloom hash for {phys}")


def hash_value(v, phys: fmt.Type) -> int:
    """XXH64 (seed 0) of a value's PLAIN bytes."""
    return native.xxh64(_value_bytes(v, phys))


def hash_values(values, phys: fmt.Type) -> np.ndarray:
    """hash_value of every value, in one call: `values` a numpy array of
    a numeric physical type or (ends, data) of byte strings."""
    if isinstance(values, tuple):
        return native.xxh64_rows(*values)
    a = np.ascontiguousarray(values, dtype=_PACK[phys])
    k = a.dtype.itemsize
    ends = np.arange(1, len(a) + 1, dtype=np.int64) * k
    return native.xxh64_rows(ends, a.view(np.uint8).reshape(-1))


class BloomFilter:
    """Split-block bloom filter over uint32 words [nblocks, 8]."""

    def __init__(self, nblocks: int):
        self.blocks = np.zeros((nblocks, 8), dtype=np.uint32)

    @property
    def num_blocks(self) -> int:
        return self.blocks.shape[0]

    def _where(self, hashes: np.ndarray):
        h = np.asarray(hashes, np.uint64)
        block = ((h >> np.uint64(32)) * np.uint64(self.num_blocks)) >> \
            np.uint64(32)
        x = (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        bits = (x[:, None] * SALT[None, :]) >> np.uint32(27)
        return block.astype(np.int64), np.left_shift(
            np.uint32(1), bits).astype(np.uint32)

    def insert_hashes(self, hashes: np.ndarray) -> None:
        block, mask = self._where(hashes)
        np.bitwise_or.at(self.blocks, block, mask)

    def check_hashes(self, hashes: np.ndarray) -> np.ndarray:
        block, mask = self._where(hashes)
        return ((self.blocks[block] & mask) == mask).all(axis=1)

    def insert_hash(self, h: int) -> None:
        self.insert_hashes(np.array([h], np.uint64))

    def check_hash(self, h: int) -> bool:
        return bool(self.check_hashes(np.array([h], np.uint64))[0])

    def insert(self, v, phys: fmt.Type) -> None:
        self.insert_hash(hash_value(v, phys))

    def check(self, v, phys: fmt.Type) -> bool:
        return self.check_hash(hash_value(v, phys))

    def serialize_parts(self) -> tuple:
        """(header thrift bytes, bitset bytes): separate so encryption can
        frame them as two modules (reference aes.go BloomFilterHeader /
        BloomFilterBitset)."""
        hdr = BloomFilterHeader(
            numBytes=self.num_blocks * BYTES_PER_BLOCK,
            algorithm=BloomFilterAlgorithm(BLOCK=SplitBlockAlgorithm()),
            hash=BloomFilterHash(XXHASH=XxHash()),
            compression=BloomFilterCompression(UNCOMPRESSED=Uncompressed()))
        w = CompactWriter()
        w.write_struct(hdr)
        return bytes(w.out), self.blocks.astype("<u4").tobytes()

    def serialize(self) -> bytes:
        """The thrift BloomFilterHeader, then the bitset."""
        hdr_b, bits = self.serialize_parts()
        return hdr_b + bits

    @staticmethod
    def deserialize(data) -> "BloomFilter":
        r = CompactReader(data)
        hdr = r.read_struct(BloomFilterHeader)
        nbytes = hdr.numBytes
        bitset = bytes(data[r.pos:r.pos + nbytes])
        bf = BloomFilter(nbytes // BYTES_PER_BLOCK)
        bf.blocks = np.frombuffer(bitset, dtype="<u4").reshape(-1, 8).copy()
        return bf


def build_bloom_filter(values, phys: fmt.Type,
                       fpp: float = 0.01) -> BloomFilter:
    """A filter sized for the distinct `values` (of physical type
    `phys`) holding each of them, as the JAX package builds it."""
    vals = [bytes(v) if isinstance(v, (bytearray, memoryview)) else v
            for v in values]
    hashes = np.array([hash_value(v, phys) for v in vals], np.uint64)
    return _build_from_hashes(hashes, len(set(vals)), fpp)


def _build_from_hashes(hashes: np.ndarray, ndv: int,
                       fpp: float = 0.01) -> BloomFilter:
    """A filter sized for `ndv` distinct values holding `hashes` (the
    writer's builder: one vectorized hash of the distinct values)."""
    bf = BloomFilter(optimal_num_blocks(ndv, fpp))
    bf.insert_hashes(hashes)
    return bf


MIN_BLOOM_BYTES = 32
MAX_BLOOM_BYTES = 128 * 1024 * 1024


def optimal_num_bytes(ndv: int, fpp: float = 0.01) -> int:
    return optimal_num_blocks(ndv, fpp) * BYTES_PER_BLOCK


def _bounded_pow2(num_bytes: int, max_bytes: int) -> int:
    num_bytes = max(num_bytes, MIN_BLOOM_BYTES)
    if num_bytes & (num_bytes - 1):
        num_bytes = 1 << num_bytes.bit_length()
    return max(min(num_bytes, max_bytes), MIN_BLOOM_BYTES)


class AdaptiveBloomFilter:
    """Candidate-set bloom builder for streams of unknown NDV (after the
    JAX package's; reference parquet/metadata/adaptive_bloom_filter.go:65
    NewAdaptiveBlockSplitBloomFilter): filters at halving sizes, the
    distinct hashes counted against the largest, a candidate dropped
    once its expected NDV is exceeded, and the smallest survivor the
    result. The port's writer sizes its filters from the exact count of
    distinct values instead (_build_from_hashes)."""

    _NDV_STEP = 500

    def __init__(self, max_bytes: int = 1 << 20, num_candidates: int = 12,
                 fpp: float = 0.01):
        if not (0 < fpp < 1):
            raise ValueError("fpp must be in (0, 1)")
        max_bytes = max(MIN_BLOOM_BYTES, min(MAX_BLOOM_BYTES, max_bytes))
        self.max_bytes = max_bytes
        self.fpp = fpp
        self.num_distinct = 0
        self.finalized = False
        self._candidates: list = []      # (expected_ndv, BloomFilter)
        size = _bounded_pow2(max_bytes, max_bytes)
        for _ in range(num_candidates):
            ndv = self._expected_ndv(size)
            if ndv <= 0:
                break
            nb = _bounded_pow2(size, max_bytes)
            self._candidates.append((ndv, BloomFilter(nb // BYTES_PER_BLOCK)))
            size = _bounded_pow2(size // 2, max_bytes)
        if not self._candidates:
            self._candidates.append(
                (16, BloomFilter(MIN_BLOOM_BYTES // BYTES_PER_BLOCK)))
        self._largest = max(self._candidates,
                            key=lambda c: c[1].num_blocks)[1]

    def _expected_ndv(self, num_bytes: int) -> int:
        ndv, optimal = 0, 0
        while optimal < num_bytes:
            ndv += self._NDV_STEP
            optimal = optimal_num_bytes(ndv, self.fpp)
        return max(0, ndv - self._NDV_STEP)

    def _prune(self) -> None:
        self._candidates = [
            (ndv, bf) for ndv, bf in self._candidates
            if bf is self._largest or ndv >= self.num_distinct]

    def insert_hash(self, h: int) -> None:
        self.insert_bulk([h])

    def insert_bulk(self, hashes) -> None:
        """Insert hashes, counting the ones new to the largest filter
        (one count before the inserts, as the JAX builder does)."""
        if self.finalized:
            raise ValueError("adaptive bloom filter already finalized")
        hashes = np.asarray(list(hashes) if not isinstance(
            hashes, np.ndarray) else hashes, np.uint64)
        if not len(hashes):
            return
        absent = ~self._largest.check_hashes(hashes)
        self.num_distinct += len(np.unique(hashes[absent]))
        self._prune()
        for _, bf in self._candidates:
            bf.insert_hashes(hashes)

    def insert(self, v, phys: fmt.Type) -> None:
        self.insert_hash(hash_value(v, phys))

    def check_hash(self, h: int) -> bool:
        return self._largest.check_hash(h)

    def size(self) -> int:
        return self._optimal().num_blocks * BYTES_PER_BLOCK

    def _optimal(self) -> BloomFilter:
        return min(self._candidates, key=lambda c: c[1].num_blocks)[1]

    def finalize(self) -> BloomFilter:
        """The smallest surviving candidate: what a writer stores."""
        self.finalized = True
        return self._optimal()


def build_bloom_filter_adaptive(values, phys: fmt.Type, fpp: float = 0.01,
                                max_bytes: int = 1 << 20) -> BloomFilter:
    """A filter of `values` (Python values, or what `hash_values` takes)
    of physical type `phys`, sized by an AdaptiveBloomFilter, for a
    stream whose NDV is unknown."""
    ab = AdaptiveBloomFilter(max_bytes=max_bytes, fpp=fpp)
    ab.insert_bulk(hash_values(values, phys) if isinstance(
        values, (np.ndarray, tuple)) else [hash_value(v, phys)
                                            for v in values])
    return ab.finalize()
