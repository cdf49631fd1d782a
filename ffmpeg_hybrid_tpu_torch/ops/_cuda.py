"""What the port's kernel wrappers share: the check of a tensor argument,
and the launch of an entry point of a csrc/ library on the current
stream."""
from __future__ import annotations

import torch


def check_tensor(t, dtypes, shape, device, name):
    """t, contiguous, after checking its device, its dtype (one of the
    tuple `dtypes`) and its shape for a kernel launch."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} is {t.dtype}, the kernel takes "
                        f"{' or '.join(str(d) for d in dtypes)}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    return t.contiguous()


def launch(source, signatures, name, *args):
    """Run the C entry point `name` of csrc/`source` (built and loaded
    with the ctypes `signatures`) on the current CUDA stream. Tensors
    among `args` pass as device pointers and must lie on a CUDA device;
    raises if the entry point returns a CUDA error."""
    for a in args:
        if torch.is_tensor(a) and a.device.type != "cuda":
            raise ValueError(f"{name}: a tensor on {a.device}, not a CUDA "
                             "device")
    from .. import _build
    lib = _build.load(source, signatures)
    rc = getattr(lib, name)(*(a.data_ptr() if torch.is_tensor(a) else a
                              for a in args),
                            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")
