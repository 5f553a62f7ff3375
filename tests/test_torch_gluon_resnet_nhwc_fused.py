"""The ``nhwc_fused`` case of ``test_torch_gluon_trainer.py``'s
``test_resnet_gluon_steps_match_reference``: three Gluon steps of a tiny
ResNetV1 on both packages, held as that test's docstring says.  It has
a file of its own so that ``pytest -n N --dist loadfile`` gives it a
worker of its own.
"""
import pytest

from test_torch_gluon_trainer import (  # noqa: F401 (the autouse fixture)
    _hold_resnet_gluon_steps, _host)


@pytest.mark.parametrize("case", ["nhwc_fused"])
def test_resnet_gluon_steps_match_reference(case, monkeypatch):
    _hold_resnet_gluon_steps(case, monkeypatch)
