"""Row-sparse Adam for the per-camera pose deltas.

Counterpart of ``neddf_tpu/training/optim.py::row_sparse_adam``. The
trainer keeps every camera's 6-DoF correction in one [n_cam, 6] tensor,
and a step draws its pixels from one camera, so the gradient is zero on
every other row. Plain Adam would keep pushing those rows with a stale
first moment; here a row whose gradient is exactly zero keeps its
moments and gets no update, and bias correction uses each row's own
visit count. A row whose gradient is not finite counts as visited, so
the NaN reaches the moments and the deltas instead of being skipped.
Nothing here reads a tensor on the host: a step makes no device sync.
"""
from __future__ import annotations

from typing import Iterable, Tuple

import torch

Tensor = torch.Tensor


class RowSparseAdam(torch.optim.Optimizer):
    """Adam over row-partitioned parameters (rows = axis 0).

    State per parameter: ``m`` and ``v`` (f32, the parameter's shape) and
    ``t`` (int32 [rows], the visits of each row): the JAX package's
    ``RowSparseAdamState``.
    """

    def __init__(self, params: Iterable[Tensor], lr: float = 1e-4,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8) -> None:
        super().__init__(params, {"lr": lr, "betas": betas, "eps": eps})

    def state_of(self, p: Tensor) -> dict:
        """``p``'s state, zeros before its first step."""
        state = self.state[p]
        if not state:
            state["m"] = torch.zeros_like(p, dtype=torch.float32)
            state["v"] = torch.zeros_like(p, dtype=torch.float32)
            state["t"] = torch.zeros(p.shape[0], dtype=torch.int32, device=p.device)
        return state

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("RowSparseAdam takes no closure")
        for group in self.param_groups:
            lr, eps = group["lr"], group["eps"]
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state_of(p)
                row_sum = g.abs().reshape(g.shape[0], -1).sum(dim=1)
                active = (row_sum > 0) | ~torch.isfinite(row_sum)
                rows = active.view((-1,) + (1,) * (g.ndim - 1))
                state["t"] += active.to(torch.int32)
                state["m"] = torch.where(rows, b1 * state["m"] + (1.0 - b1) * g, state["m"])
                state["v"] = torch.where(rows, b2 * state["v"] + (1.0 - b2) * torch.square(g),
                                         state["v"])
                # visited rows only; their counts are >= 1
                tf = state["t"].clamp(min=1).to(torch.float32).view(rows.shape)
                m_hat = state["m"] / (1.0 - torch.pow(b1, tf))
                v_hat = state["v"] / (1.0 - torch.pow(b2, tf))
                update = -lr * m_hat / (torch.sqrt(v_hat) + eps)
                p.add_(torch.where(rows, update, torch.zeros_like(update)))
        return None
