"""The JAX package's utils/rowhash.py is not ported: its two jobs, the
give-up path of the native memo table and the flattening of BinaryView
layouts, have no counterpart in the port (native.factorize never gives
up, and the port's view types are dictionary-coded). This holds the
port's factorization of long byte rows, with repeats, empty rows and
rows that differ only in their last byte, to the partition that
rowhash.factorize_segments gives: two rows share a code in one exactly
when they share it in the other (the codes' order may differ)."""
import numpy as np
import pytest

from arrow_go_tpu.utils import rowhash

from arrow_go_tpu_torch import native


def _rows(seed: int, n: int, distinct: int, max_len: int):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, max_len, distinct)
    lens[0] = 0                                   # the empty row
    base = [rng.integers(0, 256, int(k), dtype=np.uint8) for k in lens]
    # rows that differ from another only in their last byte
    for i in range(1, min(distinct, 8)):
        if len(base[i]) and len(base[i - 1]) == len(base[i]):
            base[i][:-1] = base[i - 1][:-1]
    pick = rng.integers(0, distinct, n)
    parts = [base[p] for p in pick]
    lens = np.array([len(p) for p in parts], np.int64)
    data = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return data, lens


@pytest.mark.parametrize("seed,n,distinct,max_len", [
    (0, 1000, 40, 5000),          # long rows: the memo table's give-up case
    (1, 20000, 3000, 64),
    (2, 500, 500, 20000),
    (3, 64, 2, 1),
    (4, 0, 1, 1),
])
def test_factorize_partitions_as_rowhash(seed, n, distinct, max_len):
    data, lens = _rows(seed, n, distinct, max_len)
    ends = np.cumsum(lens, dtype=np.int64)
    codes, first = native.factorize(ends, data)
    starts = ends - lens
    want = rowhash.factorize_segments(data, starts, lens)
    assert want is not None
    jcodes, reps = want
    assert len(first) == len(reps)
    # the same partition: each port code maps to one rowhash code, and
    # back
    pairs = set(zip(codes.tolist(), jcodes.tolist()))
    assert len(pairs) == len(first)
    # first-occurrence codes: code c first appears at row first[c]
    if n:
        assert codes[0] == 0
        before = np.maximum.accumulate(np.concatenate(([-1], codes[:-1])))
        assert (codes <= before + 1).all()
        assert all(codes[first[c]] == c for c in range(len(first)))
        assert (first == np.sort(first)).all()
