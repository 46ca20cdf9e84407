"""The benchmark's plain reference: the ray tracer's hard renderer, its soft
renderer, the fit's loss and Adam, in plain PyTorch.

Frozen copies of the port's plain modules at commit
fa8828e2546d4fbea5df42a59f967d164dc1f66a (``models/camera.py``,
``ops/intersect.py``, ``ops/shade.py``, ``ops/render.py``, ``ops/soft.py``),
with one change: every function computes in the dtype of its inputs, so that
the same code gives the float32 reference and its bfloat16 control. It imports
torch and numpy only: nothing of the port, nothing of JAX. Float32 matmuls are
never used (every product is written out), and :func:`strict_float32` turns
TF32 off for the process all the same."""
from __future__ import annotations

import torch


def strict_float32() -> None:
    """No TF32 anywhere: the reference's float32 is float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
