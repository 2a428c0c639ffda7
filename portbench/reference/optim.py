"""A plain AdamW with a global-norm clip, written out from its
definition (Loshchilov and Hutter's decoupled weight decay; the clip
scales every gradient by ``clip / ‖g‖`` when the global norm ``‖g‖`` is
at least ``clip``), with a cosine learning rate from ``lr`` to 0 over
``total_steps`` and no warm-up. Decay applies to every leaf."""

import math

import torch


class AdamW:
    def __init__(self, lr, b1, b2, eps, weight_decay, clip_norm,
                 total_steps):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd, self.clip = weight_decay, clip_norm
        self.total = total_steps
        self.t = 0
        self.mu, self.nu = {}, {}

    def rate(self, t):
        """The learning rate of update ``t`` (0-based)."""
        return self.lr * 0.5 * (1 + math.cos(math.pi * min(t, self.total)
                                             / self.total))

    @torch.no_grad()
    def step(self, params, grads):
        """Update ``params`` (``{path: tensor}``) in place from
        ``grads`` → each leaf's norm of its clipped gradient (0-d
        tensors)."""
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        scale = torch.where(norm < self.clip, torch.ones_like(norm),
                            self.clip / norm)
        lr = self.rate(self.t)
        self.t += 1
        clipped = {}
        for k, p in params.items():
            g = grads[k] * scale
            clipped[k] = torch.linalg.vector_norm(g)
            mu = self.mu.get(k, torch.zeros_like(p))
            nu = self.nu.get(k, torch.zeros_like(p))
            self.mu[k] = mu = self.b1 * mu + (1 - self.b1) * g
            self.nu[k] = nu = self.b2 * nu + (1 - self.b2) * g * g
            m_hat = mu / (1 - self.b1 ** self.t)
            v_hat = nu / (1 - self.b2 ** self.t)
            p -= lr * (m_hat / (torch.sqrt(v_hat) + self.eps)
                       + self.wd * p)
        return clipped
