"""What the zoo's model files share: the refusal of pretrained
weights, and the branch concatenation."""
from __future__ import annotations

import torch

from ....base import MXNetError


def no_pretrained(pretrained):
    """Pretrained weights are not fetched: load a local ``.params`` file
    with ``Block.load_parameters`` instead."""
    if pretrained:
        raise MXNetError(
            "pretrained weights are not downloadable in this environment; "
            "load a local .params file with load_parameters")


def concat(outs):
    """Channel concatenation of branch outputs (the reference's
    ``F.concat(..., dim=1)``)."""
    return torch.cat(outs, dim=1)
