"""Adam, written out (Kingma and Ba, 2015, Algorithm 1), with the
projection of a density grid onto ``>= 0`` after each update, as a grid
inversion keeps it."""

from __future__ import annotations

import torch


class Adam:
    """``step(p, g)`` updates ``p`` in place from the gradient ``g``."""

    def __init__(self, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.t, self.m, self.v = 0, None, None

    def step(self, p: torch.Tensor, g: torch.Tensor,
             clamp_min=None) -> None:
        if self.m is None:
            self.m, self.v = torch.zeros_like(p), torch.zeros_like(p)
        self.t += 1
        self.m.mul_(self.b1).add_((1 - self.b1) * g)
        self.v.mul_(self.b2).add_((1 - self.b2) * g * g)
        m_hat = self.m / (1 - self.b1 ** self.t)
        v_hat = self.v / (1 - self.b2 ** self.t)
        p.sub_(self.lr * m_hat / (v_hat.sqrt() + self.eps))
        if clamp_min is not None:
            p.clamp_(min=clamp_min)
