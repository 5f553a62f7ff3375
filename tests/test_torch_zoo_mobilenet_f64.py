"""MobileNet's case of ``test_torch_zoo.py``'s
``test_ill_conditioned_steps_match_reference_in_float64``: three
float64 steps of both packages and the fp32 step 1, held as that file's
docstring says.  It has a file of its own so that ``pytest -n N --dist
loadfile`` gives it a worker of its own: the reference's float64 steps
take most of a minute alone.
"""
import pytest

from test_torch_zoo import (  # noqa: F401 (the autouse fixture)
    _hold_ill_conditioned, _on_cpu)


@pytest.mark.parametrize("family", ["mobilenet"])
def test_ill_conditioned_steps_match_reference_in_float64(family,
                                                          monkeypatch):
    _hold_ill_conditioned(family, monkeypatch)
