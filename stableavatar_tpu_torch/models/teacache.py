"""TeaCache: timestep-embedding-aware skipping of the DiT block stack (port of
`stableavatar_tpu/models/teacache.py`).

A host-side controller: the skip decision is Python control flow over a
call counter and a scalar rel-L1 distance between successive modulated time
embeddings e0, rescaled by a polynomial.  Semantics kept: the counter
advances once per transformer call (per window per step in the long
pipeline); the first call, the last step's call and the first
`num_skip_start_steps` calls always compute.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

TEACACHE_COEFFICIENTS = {
    "wan2.1-t2v-1.3b": [-5.21862437e04, 9.23041404e03, -5.28275948e02, 1.36987616e01, -4.99875664e-02],
    "wan2.1-t2v-14b": [-3.03318725e05, 4.90537029e04, -2.65530556e03, 5.87365115e01, -3.15583525e-01],
    "wan2.1-i2v-14b-480p": [2.57151496e05, -3.54229917e04, 1.40286849e03, -1.35890334e01, 1.32517977e-01],
    "wan2.1-i2v-14b-720p": [8.10705460e03, 2.13393892e03, -3.72934672e02, 1.66203073e01, -4.17769401e-02],
}


def get_teacache_coefficients(model_name: str) -> Optional[list]:
    name = model_name.lower()
    for key, coef in TEACACHE_COEFFICIENTS.items():
        if key in name:
            return coef
    if "1.3b" in name or "1b" in name:
        return TEACACHE_COEFFICIENTS["wan2.1-t2v-1.3b"]
    return None


class TeaCache:
    """Host-side skip controller; `plan(e0)` returns True to compute the
    block stack, False to replay the cached residual."""

    def __init__(self, coefficients, num_steps: int, rel_l1_thresh: float = 0.1,
                 num_skip_start_steps: int = 0):
        if num_steps < 1:
            raise ValueError("num_steps must be >= 1")
        if rel_l1_thresh < 0:
            raise ValueError("rel_l1_thresh must be >= 0")
        self.coefficients = list(coefficients)
        self.rescale = np.poly1d(self.coefficients)
        self.num_steps = num_steps
        self.rel_l1_thresh = rel_l1_thresh
        self.num_skip_start_steps = num_skip_start_steps
        self.reset()

    def reset(self):
        self.cnt = 0
        self.accumulated = 0.0
        self.prev_modulated: Optional[torch.Tensor] = None
        self.residual: Optional[torch.Tensor] = None
        self.skipped_calls = 0
        self.total_calls = 0

    def plan(self, modulated_input: torch.Tensor, can_skip: bool = True) -> bool:
        """Decide compute (True) or skip (False) for this call and advance
        the counter.  `can_skip=False` forces a compute (no cached residual
        yet) and counts the call as computed."""
        self.total_calls += 1
        skip_window = self.cnt < self.num_skip_start_steps
        if self.cnt == 0 or self.cnt == self.num_steps - 1 or skip_window or not can_skip:
            should_calc = True
            self.accumulated = 0.0
        else:
            # in e0's dtype, each mean rounded to it, as jnp.mean does
            prev, cur = self.prev_modulated, modulated_input
            rel = float((cur - prev).abs().mean() / prev.abs().mean())
            self.accumulated += float(self.rescale(rel))
            if self.accumulated < self.rel_l1_thresh:
                should_calc = False
            else:
                should_calc = True
                self.accumulated = 0.0
        self.prev_modulated = modulated_input
        self.cnt += 1
        if self.cnt == self.num_steps:
            self.reset_counter_only()
        if not should_calc:
            self.skipped_calls += 1
        return should_calc

    def reset_counter_only(self):
        self.cnt = 0
        self.accumulated = 0.0

    def store(self, residual: torch.Tensor):
        self.residual = residual
