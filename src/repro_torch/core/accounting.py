"""Privacy accounting (the port so far needs only the sensitivity rule;
the RDP accountant and the privacy ledger are ROADMAP work)."""
from __future__ import annotations

import math


def compose_sensitivity(Rs) -> float:
    """L2 sensitivity of one sample's clipped contribution under group-wise
    clipping: each clipping unit bounds its slice of the per-sample gradient
    by R_u on disjoint coordinates, so the vector norm composes as
    sqrt(sum_u R_u^2) (He et al. 2022). A single flat unit recovers R."""
    return math.sqrt(sum(float(R) ** 2 for R in Rs))
