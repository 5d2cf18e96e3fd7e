"""Anti-aliased SnakeBeta activation kernel K9 (``csrc/aa_snake.cu``) and its plain twin.

``aa_snake(x, alpha, beta, up_filter, down_filter)`` is BigVGAN's
``Activation1d`` with a log-scale SnakeBeta, ``Down(SnakeBeta(Up(x)))``, on
(B, C, L) float32: upsample by 2 (replicate pad 5, a depthwise stride-2
transposed convolution with the 12-tap ``up_filter``, times 2, cut to
[15 : -15]), ``s = u + sin(u e^alpha)^2 / (e^beta + 1e-9)`` per channel,
then downsample by 2 (replicate pad 5 left and 6 right, a depthwise stride-2
convolution with ``down_filter``).  On a CUDA tensor it launches K9, one
pass that reads x once and writes y once; on a CPU tensor it runs
``aa_snake_plain``, which repeats the kernel's index arithmetic (each output
of the two filters as a gather of clamped indices) in PyTorch.  It counts
its kernel launches in ``aa_snake.launches`` and, while ``utils.profiling``
records, in the counter ``aa_snake.launches``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from ..utils import profiling

TAPS = 12      # both filters (csrc/aa_snake.cu kTaps; a CPU test holds it)


def aa_snake_plain(x, alpha, beta, up_filter, down_filter):
    """The kernel's function in PyTorch (see the module note and the
    kernel's): u[2i] = 2 sum_q f[2q+1] x[i+2-q], u[2i+1] = 2 sum_q f[2q]
    x[i+3-q], y[t] = sum_k g[k] s[2t+k-5], indices clamped to the row."""
    B, C, L = x.shape
    dev = x.device
    f, g = up_filter.reshape(TAPS).float(), down_filter.reshape(TAPS).float()
    i = torch.arange(L, device=dev)[:, None]
    q = torch.arange(TAPS // 2, device=dev)
    x = x.float()
    even = (x[..., (i + 2 - q).clamp(0, L - 1)] * f[1::2]).sum(-1)
    odd = (x[..., (i + 3 - q).clamp(0, L - 1)] * f[0::2]).sum(-1)
    u = 2.0 * torch.stack([even, odd], -1).reshape(B, C, 2 * L)
    a = torch.exp(alpha.float())[:, None]
    ib = (1.0 / (torch.exp(beta.float()) + 1e-9))[:, None]
    s = u + ib * torch.sin(u * a) ** 2
    t = torch.arange(L, device=dev)[:, None]
    k = torch.arange(TAPS, device=dev)
    return (s[..., (2 * t + k - 5).clamp(0, 2 * L - 1)] * g).sum(-1)


_lock = threading.Lock()
_fn = None


def _kernel():
    """``t2v_aa_snake`` with its C signature, resolved once."""
    global _fn
    with _lock:
        if _fn is None:
            fn = _build.load("aa_snake").t2v_aa_snake
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            _fn = fn
        return _fn


def aa_snake(x, alpha, beta, up_filter, down_filter):
    """(B, C, L) float32 -> (B, C, L): K9 on CUDA, the twin on the CPU."""
    if x.device.type == "cpu":
        return aa_snake_plain(x, alpha, beta, up_filter, down_filter)
    if not x.is_cuda:
        raise ValueError(f"aa_snake runs on CUDA or CPU, not {x.device}")
    if x.dtype != torch.float32 or x.ndim != 3:
        raise ValueError("aa_snake takes a float32 (B, C, L) tensor")
    B, C, L = x.shape
    for name, t, n in (("alpha", alpha, C), ("beta", beta, C), ("up_filter", up_filter, TAPS),
                       ("down_filter", down_filter, TAPS)):
        if t.numel() != n or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{name} must hold {n} float32 values on {x.device}")
    x = x.contiguous()
    args = [t.contiguous() for t in (alpha, beta, up_filter, down_filter)]
    y = torch.empty_like(x)
    err = _kernel()(x.data_ptr(), *(t.data_ptr() for t in args), y.data_ptr(), B * C, C, L,
                    torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "t2v_aa_snake")
    aa_snake.launches += 1
    profiling.count("aa_snake.launches")
    return y


aa_snake.launches = 0
