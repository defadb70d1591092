"""The plain reference: PyTorch and NumPy only, no kernel, nothing of the
port. It works out again, from the inputs and the port's own state, what
the timed path produced."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def float32_precision(tf32: bool = False):
    """The reference's arithmetic: float32 matmuls and convolutions with
    TF32 off (the port's own setting); tf32=True is the control's."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
