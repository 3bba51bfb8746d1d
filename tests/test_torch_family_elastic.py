"""Port parity: an elastic resize, W 4 -> 2, on every model family (the
smoke model of each family test file) against the reference's ``fit``;
the runs and their tolerances are in ``tests/_torch_family_runs.py``."""
import pytest

from _torch_family_runs import FAMILIES, check_family


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_resize_matches_reference(family):
    check_family(family, "resize")
