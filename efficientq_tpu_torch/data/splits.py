"""Dataset split generation (the reference's ``utils/misc.py:105-147``).

A copy of the JAX package's ``data/splits.py``: helpers that author the
``round<k>/`` split files ``DataHub`` reads.  Python ``random`` with an
explicit seed, so the same subject list and seed give the same splits in
both packages.
"""
from __future__ import annotations

import random
from typing import List, Optional, Sequence


def random_split(file_list: Sequence[str], split_nums: Sequence[float],
                 seed: Optional[int] = None) -> List[List[str]]:
    """Shuffle then partition ``file_list`` proportionally to ``split_nums``;
    each split is returned sorted (misc.py:105-116)."""
    rng = random.Random(seed)
    files = list(file_list)
    rng.shuffle(files)
    total = sum(split_nums)
    accum = [round(sum(split_nums[:i]) / total * len(files))
             for i in range(len(split_nums) + 1)]
    splits = [sorted(files[accum[i]:accum[i + 1]])
              for i in range(len(split_nums))]
    return splits


def list_join(*lists: Sequence[str]) -> List[str]:
    joined: List[str] = []
    for li in lists:
        joined += list(li)
    return joined


def cross_validation_random_split(file_list: Sequence[str], num_rounds: int,
                                  num_splits: int,
                                  seed: Optional[int] = None
                                  ) -> List[List[List[str]]]:
    """num_rounds-fold rotation: shuffle once, segment, and per round take
    the leading segments (joined) as train and the trailing num_splits-1
    segments as val/test..., rotating segments between rounds
    (misc.py:126-147)."""
    rng = random.Random(seed)
    files = list(file_list)
    rng.shuffle(files)
    n = len(files)
    per = n // num_rounds
    segments = [files[i * per:(i + 1) * per] for i in range(num_rounds - 1)]
    segments.append(files[(num_rounds - 1) * per:])
    rounds = []
    for _ in range(num_rounds):
        splits = [list_join(*segments[:-(num_splits - 1)])]
        splits += [list(s) for s in segments[-(num_splits - 1):]]
        splits = [sorted(s) for s in splits]
        rounds.append(splits)
        segments = segments[1:] + segments[0:1]
    return rounds


def write_split_files(split_dir: str, round_idx: int, splits,
                      names=("train", "val", "test")) -> None:
    """Write round<k>/{train,val,test}.txt in the layout DataHub reads
    (src/dataloader/datahub.py:54-65)."""
    import os
    import os.path as P

    assert len(names) == len(splits), (
        f"{len(splits)} splits but {len(names)} names — pass names= "
        f"matching the split count")
    d = P.join(split_dir, f"round{round_idx}")
    os.makedirs(d, exist_ok=True)
    for name, split in zip(names, splits):
        with open(P.join(d, f"{name}.txt"), "w") as f:
            f.write("\n".join(split) + "\n")
