"""The fig13_coil20 case of test_torch_paper_sec5.py's
`test_figure_matches_reference`, in a file of its own so that it runs on
another worker than the other figures (`--dist loadfile` keeps a file on
one worker).  The same check, cap and fixtures: `check_figure` (with
its `CAP`), `jfigs`, `_x64` and `_one_thread` come from
test_torch_paper_sec5.py.
"""
import pytest

from test_torch_paper_sec5 import (  # noqa: F401
    _one_thread, _x64, check_figure, jfigs)


@pytest.mark.parametrize("fig", ["fig13_coil20"])
def test_figure_matches_reference(jfigs, fig):  # noqa: F811
    check_figure(jfigs, fig)
