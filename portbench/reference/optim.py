"""Plain Adam (Kingma & Ba, Algorithm 1; β1 0.9, β2 0.999, ε 1e-8 added
to the bias-corrected √v), every leaf stepped, a leaf without a gradient
with a zero one."""

from __future__ import annotations

from typing import Dict

import torch


class Adam:
    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, b1, b2, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g = torch.zeros_like(p) if p.grad is None else p.grad
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p -= self.lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + self.eps)
            p.grad = None
