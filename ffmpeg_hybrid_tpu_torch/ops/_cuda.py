"""What the port's kernel wrappers share: the check of a tensor argument,
the launch of an entry point of a csrc/ library on the current stream,
and a kernel's scratch kept for a stream."""
from __future__ import annotations

import ctypes
import threading

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


def _tensors(args):
    for a in args:
        if torch.is_tensor(a):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from (x for x in a if torch.is_tensor(x))


def _arg(a, keep):
    """A tensor as its device pointer; a list or tuple of tensors (or
    None) as a host array of their device pointers."""
    if torch.is_tensor(a):
        return a.data_ptr()
    if isinstance(a, (list, tuple)):
        arr = (ctypes.c_void_p * len(a))(
            *(x.data_ptr() if torch.is_tensor(x) else x for x in a))
        keep.append(arr)
        return ctypes.addressof(arr)
    return a


def launch(source, signatures, name, *args):
    """Run the C entry point `name` of csrc/`source` (built and loaded
    with the ctypes `signatures`) on the current CUDA stream. Tensors
    among `args` pass as device pointers, and lists of tensors as host
    arrays of device pointers; every tensor must lie on a CUDA device.
    Raises if the entry point returns a CUDA error."""
    for a in _tensors(args):
        if a.device.type != "cuda":
            raise ValueError(f"{name}: a tensor on {a.device}, not a CUDA "
                             "device")
    from .. import _build
    lib = _build.load(source, signatures)
    keep = []
    rc = getattr(lib, name)(*(_arg(a, keep) for a in args),
                            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


class StreamState:
    """A kernel's int32 scratch on one device for one stream, zero when
    made, and the epochs its launches take (a new one each call, never
    the same twice, on any thread)."""

    def __init__(self, buf):
        self.buf = buf
        self.epoch = 0
        self._lock = threading.Lock()

    def next_epoch(self):
        with self._lock:
            if self.epoch == 0x7fffffff:    # flags may hold any epoch
                self.buf.zero_()
                self.epoch = 0
            self.epoch += 1
            return self.epoch


_STATES = {}
_STATES_LOCK = threading.Lock()


def stream_state(name, device, n):
    """The StreamState of kernel `name` for `device` and its current
    stream, of at least n int32 words, made (zeroed) at first use or when
    a call needs more. Launches on one stream run in order, so they may
    share a scratch whose counters the kernel leaves at zero; launches on
    other streams, which may run at once, get their own."""
    device = torch.device(device)
    stream = (torch.cuda.current_stream(device).cuda_stream
              if device.type == "cuda" else 0)
    key = (name, str(device), stream)
    with _STATES_LOCK:
        st = _STATES.get(key)
        if st is None or st.buf.numel() < n:
            st = _STATES[key] = StreamState(torch.zeros(
                max(n, 64), dtype=torch.int32, device=device))
        return st
