"""Plain DeepSDF decoder (Park et al., CVPR 2019; DSP-SLAM's cars_64 layout).

An MLP over [code | xyz]: layers W_i (in, out) with ReLU between them, the
raw input concatenated back in before layer `latent_in` (so the layer
before it outputs hidden - in_dim), and a tanh on the single output.  It
reads the decoder's raw `.npz` file itself (weights W{i}, b{i}, stored in
float16 or float32), and computes the value and the input Jacobian
d sdf / d[code, xyz] layer by layer with every product's operands rounded
to one precision (`precision.py`) and float32 sums, rows in blocks.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.precision import rounder

BLOCK_ROWS = 1 << 17


class PlainDecoder:
    def __init__(self, path: str, device, precision: str = "f32"):
        with np.load(path) as z:
            self.latent_in = tuple(int(i) for i in z["latent_in"])
            self.latent = int(z["latent_size"])
            n = 0
            while f"W{n}" in z:
                n += 1
            self.W = [torch.tensor(z[f"W{i}"].astype(np.float32), device=device)
                      for i in range(n)]
            self.b = [torch.tensor(z[f"b{i}"].astype(np.float32), device=device)
                      for i in range(n)]
        self.in_dim = self.latent + 3
        self.device = device
        self.precision = precision
        self.rnd = rounder(precision)
        self.Wr = [self.rnd(W) for W in self.W]

    def _inputs(self, code, xyz):
        """code (B, L) per object over xyz (B, n, 3) -> rows (B*n, L+3)."""
        B, n = xyz.shape[:2]
        return torch.cat([code[:, None, :].expand(B, n, self.latent), xyz], -1) \
            .reshape(B * n, self.in_dim).float()

    def _forward(self, x, keep_masks):
        rnd, h, masks, last = self.rnd, x, [], len(self.W) - 1
        for i, (W, b) in enumerate(zip(self.Wr, self.b)):
            if i in self.latent_in:
                h = torch.cat([h, x], -1)
            pre = rnd(h) @ W + b
            if i < last:
                if keep_masks:
                    masks.append(pre > 0)
                h = torch.relu(pre)
        return torch.tanh(pre[:, 0]), masks

    def _jacobian(self, x):
        sdf, masks = self._forward(x, True)
        rnd, last = self.rnd, len(self.W) - 1
        g = (1.0 - sdf * sdf)[:, None]
        extra = 0.0
        for i in range(last, -1, -1):
            if i < last:
                g = g * masks[i]
            g = rnd(g) @ self.Wr[i].T
            if i in self.latent_in:
                extra = extra + g[:, -self.in_dim:]
                g = g[:, :-self.in_dim]
        return sdf, g + extra

    def value(self, code, xyz):
        """SDF at xyz (B, n, 3) for per-object codes (B, L) -> (B, n)."""
        x = self._inputs(code, xyz)
        out = torch.cat([self._forward(x[i:i + BLOCK_ROWS], False)[0]
                         for i in range(0, x.shape[0], BLOCK_ROWS)])
        return out.reshape(xyz.shape[:2])

    def value_and_jacobian(self, code, xyz):
        """(sdf (B, n), d sdf / d[code, xyz] (B, n, L+3))."""
        x = self._inputs(code, xyz)
        parts = [self._jacobian(x[i:i + BLOCK_ROWS]) for i in range(0, x.shape[0], BLOCK_ROWS)]
        sdf = torch.cat([p[0] for p in parts]).reshape(xyz.shape[:2])
        jac = torch.cat([p[1] for p in parts]).reshape(xyz.shape[:2] + (self.in_dim,))
        return sdf, jac
