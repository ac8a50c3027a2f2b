"""The comparisons that decide `correct` in a data-parallel training cell:
rank 0's readings of the checked steps (the losses and gradient of the
global batch, each leaf's change), with the other ranks' tokenizer ids and
parameter fingerprints, against the fp32 reference trained on the union of
the ranks' batches with each rank's own draws
(`reference/train_union.py`).

  tok_gap, loss_rel, grad_gap, change_gap   as `judge.py` has them for a
              training cell, over the union's rows: the same arithmetic,
              with a mean over the ranks added;
  rank_gap    the (rank, leaf) pairs whose parameters after the checked
              steps are not bit-equal to rank 0's (their fingerprints
              differ): 0 when the ranks hold the same model.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from cvbench import judge
from cvbench.reference import train_union as ru
from cvbench.reference.prec import Prec


def union_batches(batches: Sequence[Sequence[Dict]]) -> List[Dict]:
    """Each step's batch of every rank's rows, in rank order."""
    return [{k: torch.cat([rank[s][k] for rank in batches]) for k in batches[0][s]}
            for s in range(len(batches[0]))]


def union_ids(ids: Sequence[Sequence]) -> List:
    """Each step's (control, image) ids, per scale, of every rank's rows."""
    out = []
    for s in range(len(ids[0])):
        pair = []
        for i in range(2):
            scales = zip(*[rank[s][i] for rank in ids])
            pair.append([torch.cat([t.to(ids[0][s][i][0].device) for t in ts]) for ts in scales])
        out.append(tuple(pair))
    return out


def reference_union(cfg: Dict, seed: int, batches: Sequence[Dict],
                    generators: Sequence[torch.Generator], sizes: Sequence[int], device,
                    prec: Prec, ids=None) -> Dict:
    """`judge.reference_train` over union batches with the ranks' draws."""
    with ru.rank_draws(generators, sizes):
        return judge.reference_train(cfg, seed, batches, None, device, prec, ids)


def rank_gap(mine, others: Sequence) -> int:
    """The (rank, leaf) pairs whose fingerprint differs from rank 0's."""
    return sum(a != b for other in others for a, b in zip(mine, other))


def check_dp(cfg: Dict, seed: int, batches: Sequence[Sequence[Dict]],
             generators_fn: Callable[[], List[torch.Generator]], device, readings: Dict,
             others: Sequence[Dict], control: bool = False) -> Dict[str, float]:
    """The numbers of the checked steps. batches: each rank's checked
    batches; readings: rank 0's (losses, grad, change, ids, fingerprint);
    others: ranks 1 ..'s (ids, fingerprint). With control, the reference at
    fp8 in the program's place, on its own ids, and rank_gap 0."""
    sizes = [rank[0]["cls"].shape[0] for rank in batches]
    union = union_batches(batches)
    if control:
        got = reference_union(cfg, seed, union, generators_fn(), sizes, device, Prec("fp8"))
        gap = 0
    else:
        ids = [judge._complete(cfg, seed, rank, rank_ids, device) for rank, rank_ids in
               zip(batches, [readings["ids"]] + [o["ids"] for o in others])]
        got = dict(readings, ids=union_ids(ids))
        gap = rank_gap(readings["fingerprint"], [o["fingerprint"] for o in others])
    ids = judge._complete(cfg, seed, union, got["ids"], device)
    want = reference_union(cfg, seed, union, generators_fn(), sizes, device, Prec(), ids)
    return dict(tok_gap=judge.train_tok_gap(cfg, seed, union, got["ids"], device),
                **judge.judge_train(got, want), rank_gap=float(gap))
