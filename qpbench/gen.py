"""The benchmark's own form of a batch of problems, and what every family
of problems and every traffic pattern shares.

A family (``families/<family>.py``) draws one batch from the run's seed on
the device: a :class:`QP` of float64 tensors, or a block form of its own
with ``dense()`` (its :class:`QP`) and ``with_step(a, l, u)``. The
:class:`QP` is what the judge and the reference read. Generators are seeded
by :func:`stream_seed` from the run's seed and a purpose, so the same seed
gives the same inputs. :func:`drift` is the control step of
``jrlqp_tpu_torch.testing.ik_gen.ik_step``: drift N(0, 1) noise on a and one
drift N(0, 1) shift per constraint on both l and u.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

F64 = torch.float64


@dataclasses.dataclass
class QP:
    """min 0.5 x'Gx + a'x s.t. l <= Cx <= u, xl <= x <= xu, per lane."""

    G: torch.Tensor
    a: torch.Tensor
    C: torch.Tensor
    l: torch.Tensor
    u: torch.Tensor
    xl: torch.Tensor
    xu: torch.Tensor

    def lanes(self, idx) -> "QP":
        return QP(**{f.name: getattr(self, f.name)[idx]
                     for f in dataclasses.fields(self)})

    def numpy(self) -> dict:
        return {f.name: getattr(self, f.name).double().cpu().numpy()
                for f in dataclasses.fields(self)}

    def dense(self) -> "QP":
        return self

    def with_step(self, a, l, u) -> "QP":
        return dataclasses.replace(self, a=a, l=l, u=u)


def stream_seed(seed: int, *purpose: int) -> int:
    """A 63-bit generator seed for (run seed, purpose...): numpy's
    SeedSequence mixes them, so nearby run seeds give unrelated streams."""
    ss = np.random.SeedSequence([seed % 2 ** 64, *purpose])
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


def generator(device, seed: int, *purpose: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, *purpose))


def drift(base: QP, scale: float, seed: int, step: int
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(a, l, u) of control step ``step`` around ``base``: fresh ``scale``
    N(0, 1) noise on a, one ``scale`` N(0, 1) shift per constraint added to
    both l and u (``ik_step`` of the port's testing package)."""
    gen = generator(base.a.device, seed, 3, step)
    kw = dict(generator=gen, dtype=F64, device=base.a.device)
    da = scale * torch.randn(base.a.shape, **kw)
    db = scale * torch.randn(base.l.shape, **kw)
    return base.a + da, base.l + db, base.u + db
