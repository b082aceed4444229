"""The frozen bound arithmetic reproduces the bounds PERF.md's kernel table
gives at 1e5 rows (rows 8, 9, 6 and 7)."""

import pytest

from helpers import FGBENCH  # noqa: F401  (puts the harness on sys.path)


@pytest.mark.parametrize(
    "args, want",
    [
        ((100000, 93, True, False, True, 1), 0.132),
        ((100000, 93, True, True, True, 1), 0.225),
        ((100000, 126, True, False, False, 2), 0.131),
        ((100000, 126, True, True, False, 2), 0.212),
    ],
)
def test_field_bound_at_1e5_rows(args, want):
    import bounds

    assert round(bounds.field_bound(*args)[0], 3) == want


def test_compositor_bounds_grow_with_the_walked_pairs():
    import bounds

    a = bounds.compositor_bound(100000, 5, 160000, 300, 307200, 10_000_000)[0]
    b = bounds.compositor_bound(100000, 5, 160000, 300, 307200, 20_000_000)[0]
    assert b == pytest.approx(2 * a)
    assert bounds.backward_bound(100000, 5, 160000, 300, 307200, 10_000_000)[0] > a
