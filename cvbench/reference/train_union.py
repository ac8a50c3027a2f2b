"""Reference training steps over the union of several data-parallel ranks'
batches: `reference/train.py:train_steps` on the rows of every rank at
once inside `rank_draws`, where each rank's random draws (the class and
cond-type drop, then the drop path) are made from that rank's own
generator at its own batch size, as the rank draws them, and laid side by
side in rank order. The loss is the mean
over all the union's rows, which is the mean over the ranks of each rank's
mean when the ranks hold equal batches.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Sequence

import torch

from cvbench.reference import controlvar as cv


@contextlib.contextmanager
def rank_draws(generators: Sequence[torch.Generator], sizes: Sequence[int]):
    """Inside, each step's `controlvar.drop_draws` (the one draw of
    `reference/train.py:train_steps`, whose generator argument it ignores)
    is each rank's own `drop_draws` at its batch size, concatenated over
    the rows in rank order, so the reference's steps over union batches
    (rank order, `sizes` rows each) take every rank's own draws."""
    own = cv.drop_draws

    def drawn(_generator, m: Dict, B: int):
        if B != sum(sizes):
            raise ValueError(f"a union batch of {B} rows; the ranks hold {list(sizes)}")
        draws = [own(g, m, n) for g, n in zip(generators, sizes)]
        return (torch.cat([d for d, _ in draws], dim=1), torch.cat([k for _, k in draws], dim=2))

    cv.drop_draws = drawn
    try:
        yield
    finally:
        cv.drop_draws = own
