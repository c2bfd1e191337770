"""_rank_invert (ops/scan.py) against a NumPy reference, at sizes that are
and are not multiples of 128."""

import numpy as np
import pytest

from merpcr_tpu.ops.scan import _rank_invert


def _reference(cnt, cap_out):
    """Slot q of [0, min(sum(cnt), cap_out)) -> (source, exclusive prefix
    sum of that source), by explicit expansion."""
    excl = np.concatenate(([0], np.cumsum(cnt)[:-1]))
    src = np.repeat(np.arange(len(cnt)), cnt)[:cap_out]
    return src, excl[src]


@pytest.mark.parametrize(
    "n_src, cap_out, density",
    [
        (1024, 1024, 0.3),   # multiples of 128, the compaction caps
        (1024, 2048, 0.9),
        (1000, 1000, 0.5),   # neither a multiple of 128
        (8, 256, 1.0),       # the hits stage: per-chunk counts
        (130, 300, 0.7),
        (129, 128, 1.0),     # total overflows the capacity
    ],
)
def test_rank_invert_matches_numpy(n_src, cap_out, density):
    rng = np.random.default_rng(n_src * 7 + cap_out)
    cnt = np.where(
        rng.random(n_src) < density, rng.integers(1, 5, n_src), 0
    ).astype(np.int32)
    src, excl = (np.asarray(a) for a in _rank_invert(cnt, cap_out))
    want_src, want_excl = _reference(cnt, cap_out)
    k = len(want_src)
    assert src.shape == excl.shape == (cap_out,)
    np.testing.assert_array_equal(src[:k], want_src)
    np.testing.assert_array_equal(excl[:k], want_excl)


def test_rank_invert_all_empty():
    src, excl = _rank_invert(np.zeros(256, np.int32), 256)
    assert np.asarray(src).shape == (256,)
    assert int(np.asarray(excl).max()) == 0
