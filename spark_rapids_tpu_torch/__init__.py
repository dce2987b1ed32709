"""spark-rapids-tpu on PyTorch and CUDA: the port of the columnar engine.

A second package beside `spark_rapids_tpu` (the JAX reference, which it
never imports). It keeps the reference's module paths, class and function
names and batch contract, so each piece can be held against its
counterpart array for array. Device kernels on the main path are CUDA C++
written by hand for Hopper (`kernels/csrc`); every one keeps a plain
PyTorch version beside it, which runs only for tensors on the CPU.

Entry points (`columnar.arrow_bridge.arrow_to_device`, the cached-relation
upload) put data on `cuda` unless the caller asks for `device="cpu"`;
operators follow their inputs' device. Without a GPU and without an
explicit device, they raise: the port never moves work to the CPU on its
own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point uploads to: `cuda` by default, the CPU
    only when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "spark_rapids_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions of its kernels on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
