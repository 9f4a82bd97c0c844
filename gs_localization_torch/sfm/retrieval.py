"""Global-descriptor retrieval: top-k database images per query.

Equivalent of hloc's pairs_from_retrieval: dot-product scores between
L2-normalized global descriptors with self/invalid masking, as one
(Q, D) x (D, N) float32 matrix product on ``device``. The top-k is a stable
descending sort, so equal scores come lowest index first, as with
``lax.top_k``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from .features import top_k_stable


def top_k_retrieval(
    query_desc,                      # (Q, D) numpy or tensor
    db_desc,                         # (N, D)
    k: int = 10,
    query_names: Optional[Sequence[str]] = None,
    db_names: Optional[Sequence[str]] = None,
    mask_self: bool = True,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (indices (Q, k), scores (Q, k)) as numpy."""
    dev = resolve_device(device)
    q = torch.as_tensor(np.asarray(query_desc, np.float32), device=dev)
    d = torch.as_tensor(np.asarray(db_desc, np.float32), device=dev)
    q = q / torch.clamp_min(torch.linalg.norm(q, dim=1, keepdim=True), 1e-12)
    d = d / torch.clamp_min(torch.linalg.norm(d, dim=1, keepdim=True), 1e-12)
    scores = torch.matmul(q, d.T)
    if mask_self and query_names is not None and db_names is not None:
        same = np.array(
            [[qn == dn for dn in db_names] for qn in query_names], bool
        )
        scores = torch.where(torch.as_tensor(same, device=dev), -torch.inf,
                             scores)
    top_scores, top_idx = top_k_stable(scores, k)
    return top_idx.cpu().numpy(), top_scores.cpu().numpy()


def pairs_from_retrieval(
    query_desc, db_desc, query_names, db_names, k=10, mask_self=True,
    device="cuda",
) -> List[Tuple[str, str]]:
    idx, _ = top_k_retrieval(query_desc, db_desc, k, query_names, db_names,
                             mask_self, device=device)
    return [(qn, db_names[j]) for qi, qn in enumerate(query_names)
            for j in idx[qi]]
