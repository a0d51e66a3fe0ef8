"""Batched input validation. Counterpart of
``jrlqp_tpu.validation.inconsistent_mask`` (validation.py:81-94)."""
from __future__ import annotations

import torch

from .problems import QPProblem

__all__ = ["inconsistent_mask"]


def inconsistent_mask(pb: QPProblem) -> torch.Tensor:
    """(B,) bool: True where a lane's data is inconsistent (inverted or NaN
    bounds, non-finite G/a/C)."""
    def any_(t):
        return t.flatten(1).any(dim=1)

    def all_(t):
        return t.flatten(1).all(dim=1)

    bad_bounds = (
        any_(pb.l > pb.u) | any_(pb.xl > pb.xu)
        | any_(torch.isnan(pb.l)) | any_(torch.isnan(pb.u))
        | any_(torch.isnan(pb.xl)) | any_(torch.isnan(pb.xu))
    )
    bad_data = (~all_(torch.isfinite(pb.G)) | ~all_(torch.isfinite(pb.a))
                | ~all_(torch.isfinite(pb.C)))
    return bad_bounds | bad_data
