"""Kernels K5 and K6 (``csrc/reshape_probe.cu``) and their plain twins.

The port of the two Mosaic probes of ``tools/reshape_probe.py``:

``reshape_rows_plus_one(x, S, X)`` (K5, replaces ``probe_reshape.kernel``)
maps x (B, S*X) to (B*S, X) with ``out[b*S + s, x] = x[b, s*X + x] + 1``.

``out_block_matmul(x, w, T)`` (K6, replaces ``probe_out_block.kernel``)
maps x (BS, K) and w (K, F) to (T, BS, F) with ``out[t] = x @ w``; the
kernel computes the product in its own body, in FFMA.

On a CUDA tensor each wrapper launches its kernel (or raises); on a CPU
tensor it runs its ``*_plain`` twin.  Each counts its kernel launches in
``<wrapper>.launches``.  Both are float32 only, as the probes are.

``empty_kernel(device)`` launches an empty kernel through the same path:
the floor of launch cost that K5's and K6's times are read against.  The
port itself never calls it.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


_fns: dict[str, object] = {}


def _fn(name: str, argtypes):
    """The library's C function ``name`` with its argument types (set once:
    at these sizes the host's per-call work is most of a call)."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("reshape_probe"), name)
        fn.restype, fn.argtypes = ctypes.c_int, argtypes
        _fns[name] = fn
    return fn


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def reshape_rows_plus_one_plain(x: torch.Tensor, S: int, X: int) -> torch.Tensor:
    """K5's function in PyTorch: (B, S*X) -> (B*S, X), plus one."""
    return x.reshape(x.shape[0] * S, X) + 1.0


def reshape_rows_plus_one(x: torch.Tensor, S: int, X: int) -> torch.Tensor:
    """x (B, S*X) float32, rows contiguous -> (B*S, X) float32."""
    if x.ndim != 2 or x.shape[1] != S * X:
        raise ValueError(f"reshape_rows_plus_one takes (B, {S}*{X}), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return reshape_rows_plus_one_plain(x, S, X)
    if not x.is_cuda:
        raise ValueError(f"reshape_rows_plus_one runs on CUDA or CPU, not {x.device}")
    if x.dtype != torch.float32 or x.stride(1) != 1:
        raise ValueError("reshape_rows_plus_one takes float32 rows with unit stride")
    B = x.shape[0]
    out = torch.empty((B * S, X), dtype=torch.float32, device=x.device)
    fn = _fn("t2v_reshape_plus_one", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
             + [ctypes.c_longlong, ctypes.c_void_p])
    err = fn(_ptr(x), _ptr(out), B, S, X, x.stride(0), _stream(x))
    _build.check(err, "t2v_reshape_plus_one")
    reshape_rows_plus_one.launches += 1
    return out


reshape_rows_plus_one.launches = 0


def out_block_matmul_plain(x: torch.Tensor, w: torch.Tensor, T: int) -> torch.Tensor:
    """K6's function in PyTorch: the product once, stored in T slices."""
    return (x.float() @ w.float()).unsqueeze(0).expand(T, -1, -1).contiguous()


def out_block_matmul(x: torch.Tensor, w: torch.Tensor, T: int) -> torch.Tensor:
    """x (BS, K), w (K, F) float32 -> (T, BS, F) float32, each slice x @ w."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0] or T < 1:
        raise ValueError(f"out_block_matmul takes (BS, K), (K, F) and T >= 1, got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, T={T}")
    if x.device.type == "cpu" and w.device.type == "cpu":
        return out_block_matmul_plain(x, w, T)
    if not (x.is_cuda and w.device == x.device):
        raise ValueError(f"out_block_matmul runs on one CUDA device or the CPU, not "
                         f"{x.device} and {w.device}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError("out_block_matmul takes float32 operands")
    x, w = x.contiguous(), w.contiguous()
    (BS, K), F = x.shape, w.shape[1]
    out = torch.empty((T, BS, F), dtype=torch.float32, device=x.device)
    fn = _fn("t2v_out_block_matmul", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
             + [ctypes.c_void_p])
    err = fn(_ptr(x), _ptr(w), _ptr(out), BS, K, F, T, _stream(x))
    _build.check(err, "t2v_out_block_matmul")
    out_block_matmul.launches += 1
    return out


out_block_matmul.launches = 0


def empty_kernel(device) -> None:
    """Launch the library's empty kernel on ``device``'s current stream."""
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    _build.check(_fn("t2v_empty", [ctypes.c_void_p])(stream), "t2v_empty")
