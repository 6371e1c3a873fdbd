"""Operand rounding for the plain references and their controls.

A product "in" a precision rounds both operands to it and accumulates in
float32, as the tensor cores do: `rounder(name)` gives that rounding, and
`mm`/`einsum` apply it to every operand.  "f32" leaves operands alone
(the references run with TF32 off); "tf32" keeps 10 mantissa bits (round
to nearest even); "bf16" rounds to bfloat16; "fp8" to float8 e4m3 (values
past its largest, 448, saturate).
"""
from __future__ import annotations

import torch

NAMES = ("f32", "tf32", "bf16", "fp8")


def _tf32(t: torch.Tensor) -> torch.Tensor:
    i = t.float().contiguous().view(torch.int32)
    i = (i + (((i >> 13) & 1) + 0xFFF)) & -8192
    return i.view(torch.float32)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _fp8(t: torch.Tensor) -> torch.Tensor:
    return t.float().clamp(-448.0, 448.0).to(torch.float8_e4m3fn).float()


def rounder(name: str):
    if name not in NAMES:
        raise ValueError(f"precision must be one of {NAMES}, got {name!r}")
    return {"f32": lambda t: t, "tf32": _tf32, "bf16": _bf16, "fp8": _fp8}[name]


def set_exact_matmul() -> None:
    """float32 products in float32 (no TF32) for every later matmul."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Products:
    """matmul / einsum with both operands rounded to one precision."""

    def __init__(self, name: str = "f32"):
        self.name = name
        self.rnd = rounder(name)

    def mm(self, a, b):
        return self.rnd(a) @ self.rnd(b)

    def einsum(self, eq, *ops):
        return torch.einsum(eq, *(self.rnd(o) for o in ops))
