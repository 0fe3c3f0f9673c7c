"""Head-wise Similarity-aware Reordering (HSR) -- greedy grouping (a copy
of ``repro.core.reorder``, numpy only).

Given the (H, H) CKA similarity matrix, greedily seed each group with the
most-similar unassigned pair, then fill remaining slots with the head whose
*average* similarity to the current group members is highest (paper §3.2).

The result is a list of head-index groups; concatenated it is a permutation
of range(H).  At runtime the permutation is folded into the weights
(W_q / W_k column order and fused W~_o row order), so decode never permutes
activations -- the "inverse reordering" of Fig. 3 happens offline.
"""

from __future__ import annotations

import numpy as np


def greedy_group_heads(similarity: np.ndarray, group_size: int) -> list[list[int]]:
    """Greedy HSR grouping.  ``similarity`` is symmetric (H, H)."""
    S = np.asarray(similarity, dtype=np.float64)
    H = S.shape[0]
    if H % group_size != 0:
        raise ValueError(f"{H} heads not divisible by group size {group_size}")
    if group_size == 1:
        return [[h] for h in range(H)]

    unassigned = set(range(H))
    masked = S.copy()
    np.fill_diagonal(masked, -np.inf)
    groups: list[list[int]] = []
    while unassigned:
        # Seed: the highest-similarity unassigned pair.
        idx = sorted(unassigned)
        sub = masked[np.ix_(idx, idx)]
        i, j = np.unravel_index(np.argmax(sub), sub.shape)
        group = [idx[i], idx[j]]
        unassigned -= set(group)
        # Fill: maximize mean similarity to current members.
        while len(group) < group_size and unassigned:
            cand = sorted(unassigned)
            scores = S[np.ix_(group, cand)].mean(axis=0)
            pick = cand[int(np.argmax(scores))]
            group.append(pick)
            unassigned.remove(pick)
        groups.append(sorted(group))
    return groups


def identity_groups(num_heads: int, group_size: int) -> list[list[int]]:
    """Palu-style contiguous grouping (the no-HSR baseline)."""
    if num_heads % group_size != 0:
        raise ValueError(f"{num_heads} heads not divisible by {group_size}")
    return [
        list(range(g * group_size, (g + 1) * group_size))
        for g in range(num_heads // group_size)
    ]


def groups_to_permutation(groups: list[list[int]]) -> np.ndarray:
    """Flatten groups into a head permutation (new order -> old index)."""
    perm = np.concatenate([np.asarray(g, dtype=np.int64) for g in groups])
    H = perm.shape[0]
    if sorted(perm.tolist()) != list(range(H)):
        raise ValueError("groups do not form a permutation")
    return perm


def within_group_similarity(similarity: np.ndarray, groups: list[list[int]]) -> float:
    """Mean pairwise CKA inside groups -- the quantity HSR maximizes."""
    total, count = 0.0, 0
    for g in groups:
        for a in range(len(g)):
            for b in range(a + 1, len(g)):
                total += float(similarity[g[a], g[b]])
                count += 1
    return total / max(count, 1)
