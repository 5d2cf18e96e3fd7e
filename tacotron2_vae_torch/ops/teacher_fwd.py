"""Teacher-forced decoder recurrence: kernels K3 (forward) and K4 (backward).

``teacher_fwd`` runs the training-time decoder recurrence over all T steps
(attention LSTM, location-sensitive attention, decoder LSTM, recurrent
dropout by pre-scaled masks) and returns ``ys = (h_dec, ctx, w)`` and the
residuals ``(g_att, g_dec, c_att_prev, c_dec_prev, h_att)`` (the contract of
the JAX package's ``teacher_fwd.fwd_pallas`` and of ``decoder_bptt._fwd_impl``
in its recompute regime).  ``teacher_bwd`` runs the reverse-time BPTT over
those residuals and returns the per-step streams ``(dg_att, dg_dec, dpn,
dctx, dloc)`` and the accumulators ``(dv, dWq, dWld, dpmem)``; the caller
turns them into weight gradients (``models/decoder_bptt.py``).

On a CUDA tensor each launches its kernel set (``csrc/teacher_fwd.cu``,
``csrc/teacher_bwd.cu``) through one ctypes call, which loops over T
itself (``USE_GRAPH``: as a CUDA graph, kept for calls with the same
arguments; else kernel by kernel); shapes the kernels do not take raise.  On a CPU tensor each runs
its plain twin below (``teacher_fwd_plain``, ``teacher_bwd_plain``), a port
of ``decoder_bptt._fwd_impl`` and of the recompute path of
``decoder_bptt._bwd_rule``.  Launches are counted in ``.launches``.  K4
takes the attention backward's carry-independent work off its reverse-time
chain, chunk by chunk; ``teacher_bwd.coef_steps`` adds up the reverse
steps whose coefficient pass K4 reports it launched (the counter
``teacher_bwd.coef_steps`` while ``utils.profiling`` records), T a call
when every chunk ran it.

Weights (``pack``): ``attn_w`` (P+E+H, 4H) and ``dec_w`` (H+E+H, 4H) in the
stream dtype (float32, bfloat16 or float16), columns gate-major (i, f, g, o); biases,
``query_w`` (H, A), ``loc_w`` (K, 2, F), ``loc_dense_w`` (F, A) and ``v``
(A,) in float32.  Casting points follow the XLA scan: only the LSTM product
operands are rounded to the stream dtype; the gate residuals, ``dg_*`` and
``dloc`` streams are stored in it; everything else is float32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..utils import profiling
from . import _build
from .layers import no_tf32

MAX_ROWS = 64          # batch rows one launch serves (one row tile)
_F32 = ("attn_b", "dec_b", "query_w", "loc_w", "loc_dense_w", "v")
# The stream dtypes' codes in the C entry points (StreamType in
# csrc/teacher_common.cuh; the C side refuses any other value).  bfloat16
# and float16 take the tensor-core products.
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def pack(params: dict, dtype) -> dict:
    """Scan weights for the kernels and twins: the two LSTM matrices cast to
    the stream ``dtype``, the rest float32; detached and contiguous."""
    out = {k: params[k].detach().to(dtype).contiguous() for k in ("attn_w", "dec_w")}
    out.update({k: params[k].detach().float().reshape(params[k].shape).contiguous()
                for k in _F32})
    out["v"] = out["v"].reshape(-1)
    return out


def loc_conv(w_prev, w_cum, loc_w):
    """Location conv: (B, S) x2 -> (B, S, F); loc_w (K, 2, F), 'same' pad."""
    K = loc_w.shape[0]
    with no_tf32():
        y = F.conv1d(torch.stack([w_prev, w_cum], 1), loc_w.permute(2, 1, 0),
                     padding=(K - 1) // 2)
    return y.transpose(1, 2)


def loc_conv_input_grad(dloc, loc_w):
    """Gradient of ``loc_conv`` wrt its stacked input: (B, S, F) -> (B, S, 2)."""
    K = loc_w.shape[0]
    with no_tf32():
        y = F.conv_transpose1d(dloc.transpose(1, 2), loc_w.permute(2, 1, 0),
                               padding=(K - 1) // 2)
    return y.transpose(1, 2)


def _gates(g, H):
    gi, gf, gg, go = g.split(H, dim=-1)
    return torch.sigmoid(gi), torch.sigmoid(gf), torch.tanh(gg), torch.sigmoid(go)


def _lstm_fwd(g, c_prev, H):
    i, f, gt, o = _gates(g, H)
    c = f * c_prev + i * gt
    return o * torch.tanh(c), c


def _lstm_bwd(g, c_prev, dh, dc, H):
    """Backward through one LSTM cell from its pre-activation gates (the
    cell state is recomputed from them)."""
    i, f, gt, o = _gates(g, H)
    c = f * c_prev + i * gt
    tc = torch.tanh(c)
    dct = dc + dh * o * (1.0 - tc * tc)
    dg = torch.cat([dct * gt * i * (1 - i), dct * c_prev * f * (1 - f),
                    dct * i * (1 - gt * gt), dh * tc * o * (1 - o)], dim=-1)
    return dg, dct * f


def _wide(x):
    """``x`` in float32, or kept in float64 (the twins' float64 checks)."""
    return x if x.dtype == torch.float64 else x.float()


def _energy_terms(w, h_att, w_prev, w_cum, pmem):
    """(loc (B,S,F), tanh argument's tanh (B,S,A)) of one step."""
    loc = loc_conv(w_prev, w_cum, w["loc_w"])
    q = h_att @ w["query_w"]
    return loc, torch.tanh(q[:, None, :] + loc @ w["loc_dense_w"] + pmem)


# ------------------------------------------------------------- plain twins


def teacher_fwd_plain(w, prenet_seq, memory, pmem, add_mask, masks):
    """The forward recurrence in PyTorch, with the kernel's casting points."""
    T, B, _ = prenet_seq.shape
    S, E = memory.shape[1:]
    H = w["attn_w"].shape[1] // 4
    sdt = w["attn_w"].dtype
    wa, wd = _wide(w["attn_w"]), _wide(w["dec_w"])

    def z(*s):
        return _wide(torch.zeros(s, dtype=memory.dtype, device=memory.device))

    h_att, c_att, h_dec, c_dec = z(B, H), z(B, H), z(B, H), z(B, H)
    w_prev, w_cum, ctx = z(B, S), z(B, S), z(B, E)
    out = {k: [] for k in ("h_dec", "ctx", "w", "g_att", "g_dec", "c_att", "c_dec", "h_att")}
    for t in range(T):
        out["c_att"].append(c_att)
        out["c_dec"].append(c_dec)
        x = torch.cat([prenet_seq[t], ctx, h_att], -1)
        g_att = _wide(x.to(sdt)) @ wa + w["attn_b"]
        h_att, c_att = _lstm_fwd(g_att, c_att, H)
        if masks is not None:
            h_att, c_att = h_att * _wide(masks[0][t]), c_att * _wide(masks[1][t])
        _, ta = _energy_terms(w, h_att, w_prev, w_cum, pmem)
        wt = torch.softmax(ta @ w["v"] + add_mask, dim=1)
        ctx = torch.bmm(wt[:, None, :], memory)[:, 0]
        w_cum = w_cum + wt
        w_prev = wt
        x = torch.cat([h_att, ctx, h_dec], -1)
        g_dec = _wide(x.to(sdt)) @ wd + w["dec_b"]
        h_dec, c_dec = _lstm_fwd(g_dec, c_dec, H)
        if masks is not None:
            h_dec, c_dec = h_dec * _wide(masks[2][t]), c_dec * _wide(masks[3][t])
        for k, v in (("h_dec", h_dec), ("ctx", ctx), ("w", wt), ("g_att", g_att.to(sdt)),
                     ("g_dec", g_dec.to(sdt)), ("h_att", h_att)):
            out[k].append(v)
    s = {k: torch.stack(v) for k, v in out.items()}
    return ((s["h_dec"], s["ctx"], s["w"]),
            (s["g_att"], s["g_dec"], s["c_att"], s["c_dec"], s["h_att"]))


def _cell_bwd(wx, g, c_prev, dh, dc, mh, mc, H, sdt):
    """One LSTM cell's backward as the kernels take it: the dropout masks
    on dh and dc first, dg stored in the stream dtype, then dx = dg . wx^T;
    returns (dg, dx, dc_prev)."""
    if mh is not None:
        dh, dc = dh * _wide(mh), dc * _wide(mc)
    dg, dc_prev = _lstm_bwd(_wide(g), c_prev, dh, dc, H)
    dg = dg.to(sdt)
    return dg, _wide(dg) @ wx.t(), dc_prev


def _bwd_setup(w, memory, ys):
    T, B, S = ys[2].shape
    E = memory.shape[2]
    H = w["attn_w"].shape[1] // 4
    P = w["attn_w"].shape[0] - E - H

    def z(*s):
        return _wide(torch.zeros(s, dtype=memory.dtype, device=memory.device))

    return T, B, S, E, H, P, w["attn_w"].dtype, _wide(w["attn_w"]), _wide(w["dec_w"]), z


def _mask(masks, i, t):
    return None if masks is None else masks[i][t]


def teacher_bwd_plain(w, memory, pmem, masks, dys, ys, resids, w_cum_prev):
    """The reverse-time BPTT in PyTorch (recompute regime), with the
    kernel's casting points.  ``w_cum_prev`` (T, B, S) is the cumulative
    attention before each step."""
    dh_dec_seq, dctx_seq, dw_seq = dys
    w_seq = ys[2]
    g_att_seq, g_dec_seq, c_att_prev, c_dec_prev, h_att_seq = resids
    T, B, S, E, H, P, sdt, wa, wd, z = _bwd_setup(w, memory, ys)
    v, ldw, qw = w["v"], w["loc_dense_w"], w["query_w"]
    dh_att_c, dc_att_c, dh_dec_c, dc_dec_c = z(B, H), z(B, H), z(B, H), z(B, H)
    dw_prev_c, dwcum_c, dctx_c = z(B, S), z(B, S), z(B, E)
    dv, dwq, dwld, dpmem = z(*v.shape), z(*qw.shape), z(*ldw.shape), z(B, S, pmem.shape[2])
    streams = [[None] * T for _ in range(5)]
    for t in reversed(range(T)):
        w_prev = w_seq[t - 1] if t else torch.zeros_like(w_seq[0])
        loc, ta = _energy_terms(w, h_att_seq[t], w_prev, w_cum_prev[t], pmem)

        dg_dec, dx_dec, dc_dec_c = _cell_bwd(wd, g_dec_seq[t], c_dec_prev[t],
                                             dh_dec_seq[t] + dh_dec_c, dc_dec_c,
                                             _mask(masks, 2, t), _mask(masks, 3, t), H, sdt)
        dh_att = dx_dec[:, :H] + dh_att_c
        dctx = dx_dec[:, H:H + E] + dctx_seq[t] + dctx_c
        dh_dec_c = dx_dec[:, H + E:]

        wt = w_seq[t]
        dw = dw_seq[t] + dw_prev_c + dwcum_c + torch.bmm(memory, dctx[:, :, None])[..., 0]
        de = wt * (dw - (dw * wt).sum(1, keepdim=True))
        dta = de[:, :, None] * v * (1.0 - ta * ta)
        dq = dta.sum(1)
        dh_att = dh_att + dq @ qw.t()
        dloc = dta @ ldw.t()
        dv = dv + torch.einsum("bsa,bs->a", ta, de)
        dwq = dwq + h_att_seq[t].t() @ dq
        dwld = dwld + torch.einsum("bsf,bsa->fa", loc, dta)
        dpmem = dpmem + dta
        dfeats = loc_conv_input_grad(dloc, w["loc_w"])
        dw_prev_c, dwcum_c = dfeats[..., 0], dfeats[..., 1] + dwcum_c

        dg_att, dx_att, dc_att_c = _cell_bwd(wa, g_att_seq[t], c_att_prev[t], dh_att, dc_att_c,
                                             _mask(masks, 0, t), _mask(masks, 1, t), H, sdt)
        dctx_c, dh_att_c = dx_att[:, P:P + E], dx_att[:, P + E:]
        for lst, val in zip(streams, (dg_att, dg_dec, dx_att[:, :P], dctx, dloc.to(sdt))):
            lst[t] = val
    dg_att, dg_dec, dpn, dctx, dloc = (torch.stack(s) for s in streams)
    return dg_att, dg_dec, dpn, dctx, dloc, dv, dwq, dwld, dpmem


# ---------------------------------------------------------------- wrappers


def _ptr(x):
    return ctypes.c_void_p(0 if x is None else x.data_ptr())


def _fn(lib_name, sym, n_int, n_ptr):
    fn = getattr(_build.load(lib_name), sym)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * n_int + [ctypes.c_void_p] * n_ptr
    return fn


def _dims(w, memory, pmem):
    """(H, P, E, S, A, F, K) after the checks the kernels need."""
    B, S, E = memory.shape
    H = w["attn_w"].shape[1] // 4
    P = w["attn_w"].shape[0] - E - H
    K, _, Fn = w["loc_w"].shape
    A = w["query_w"].shape[1]
    if w["attn_w"].dtype not in DTYPES:
        raise ValueError(f"stream dtype must be one of {list(DTYPES)}, got {w['attn_w'].dtype}")
    if not 1 <= B <= MAX_ROWS:
        raise ValueError(f"the recurrence kernels take 1..{MAX_ROWS} rows, got B={B}")
    if K % 2 == 0:
        raise ValueError(f"location kernel size must be odd, got {K}")
    if H % 8 or P % 4 or E % 4:
        raise ValueError(f"the recurrence kernels need H % 8 == 0 and P, E multiples "
                         f"of 4 (H={H}, P={P}, E={E})")
    if w["dec_w"].shape != (2 * H + E, 4 * H) or pmem.shape != (B, S, A):
        raise ValueError("inconsistent recurrence shapes")
    return H, P, E, S, A, Fn, K


def _check(tensors, dev):
    for name, x in tensors.items():
        if x is not None and (x.device != dev or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous on {dev}")


def _masks(masks, T, B, H, sdt):
    if masks is None:
        return (None,) * 4
    for m in masks:
        if m.shape != (T, B, H) or m.dtype != sdt:
            raise ValueError(f"dropout masks must be (T, B, H) = {(T, B, H)} in {sdt}")
    return masks


SPLIT = 4       # K-split of the float32 products: kSplit in csrc/teacher_common.cuh
CLUSTER = 4     # attention CTAs per batch row: kNC
Q_CHUNK = 64    # rows of H per query-product partial: kQChunk
TILE_K = 64     # reduction tile of the 2-byte wgmma products: kTileK
USE_GRAPH = True  # replay each call's step loop from a CUDA graph (False: the profiler's view)
GRAPHS = 4        # sets of sizes whose graph is kept, per direction (kGraphs)
RING_ALIGN = 64   # floats: each array of K4's coefficient ring starts on a multiple (kRingAlign)
RING_BYTES = 512 << 20  # K4's coefficient ring: the chunk length C is what fits in this
CHUNKS = (4, 16)  # ... clamped to these (then to T): a step's graph nodes are 5 + 3 / C


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def fwd_scratch(T, B, S, E, H, P, A, tc):
    """Element counts of K3's work buffers (beside its outputs): ``part``
    the float32 products' K-split partials (float32 stream only),
    ``qpart`` the float32 query-product partials, ``xa``/``xd`` the LSTM
    operand matrices [prenet|ctx|h_att] and [h_att|ctx|h_dec] in the stream
    dtype, two step parities of 64 rows, rows padded to the wgmma reduction
    tile (``tc``: the bf16 and float16 streams only)."""
    kap, kdp = cdiv(P + E + H, TILE_K) * TILE_K, cdiv(2 * H + E, TILE_K) * TILE_K
    return {"part": 0 if tc else SPLIT * B * 4 * H, "qpart": cdiv(H, Q_CHUNK) * B * A,
            "xa": 2 * MAX_ROWS * kap if tc else 0, "xd": 2 * MAX_ROWS * kdp if tc else 0}


def bwd_work(B, S, E, H, P, A, Fn):
    """Element counts of K4's zeroed float32 work, in the C argument order:
    dx_dec, the dh_att and dctx carries, dc_att, dc_dec, the dw_prev and
    dwcum carries, dq, the per-(row, attention CTA) dv and dWld partials,
    and a zero row of S."""
    return (B * (2 * H + E), B * H, B * E, B * H, B * H, B * S, B * S, B * A,
            B * CLUSTER * A, B * CLUSTER * Fn * A, S)


def bwd_ring(C, B, S, H, A, Fn, K):
    """Element counts of K4's coefficient ring for chunks of C steps, in
    the order of ``Ring`` in csrc/teacher_bwd.cu, each rounded up to
    ``RING_ALIGN``: the att_query partials, ta, M, N (2K taps), loc, de."""
    cbs = C * B * S
    parts = (C * cdiv(H, Q_CHUNK) * B * A, cbs * A, cbs * Fn, cbs * 2 * K, cbs * Fn, cbs)
    return tuple(cdiv(n, RING_ALIGN) * RING_ALIGN for n in parts)


def bwd_chunk(T, B, S, H, A, Fn, K):
    """K4's chunk length: the steps whose coefficients fit ``RING_BYTES``,
    within ``CHUNKS``, at most T."""
    step = 4 * sum(bwd_ring(1, B, S, H, A, Fn, K))
    return min(T, max(CHUNKS[0], min(CHUNKS[1], RING_BYTES // step)))


def _ring_tensor(C, B, S, H, A, Fn, K, device):
    """K4's coefficient ring for chunks of C steps (``bwd_ring``), float32."""
    return torch.empty(sum(bwd_ring(C, B, S, H, A, Fn, K)), dtype=torch.float32,
                       device=device)


def _run_fwd(w, prenet_seq, memory, pmem, add_mask, masks):
    dev = memory.device
    T, B, _ = prenet_seq.shape
    H, P, E, S, A, Fn, K = _dims(w, memory, pmem)
    sdt = w["attn_w"].dtype
    if prenet_seq.shape != (T, B, P):
        raise ValueError(f"prenet_seq must be (T, B, P) = {(T, B, P)}")
    masks = _masks(masks, T, B, H, sdt)
    _check({**w, "prenet_seq": prenet_seq, "memory": memory, "pmem": pmem,
            "add_mask": add_mask, **{f"m{i + 1}": m for i, m in enumerate(masks)}}, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    h_dec, h_att = torch.empty(T, B, H, **f32), torch.empty(T, B, H, **f32)
    ctx, wt = torch.empty(T, B, E, **f32), torch.empty(T, B, S, **f32)
    g_att = torch.empty(T, B, 4 * H, dtype=sdt, device=dev)
    g_dec = torch.empty_like(g_att)
    c_att, c_dec = torch.zeros(T, B, H, **f32), torch.zeros(T, B, H, **f32)
    wcum = torch.zeros(B, S, **f32)
    zeros = torch.zeros(B * max(H, E, S), **f32)
    n = fwd_scratch(T, B, S, E, H, P, A, sdt != torch.float32)
    part, qpart = torch.empty(n["part"], **f32), torch.empty(n["qpart"], **f32)
    xa = torch.empty(n["xa"], dtype=sdt, device=dev)
    xd = torch.empty(n["xd"], dtype=sdt, device=dev)
    err = _fn("teacher_fwd", "t2v_teacher_fwd", 11, 31)(
        DTYPES[sdt], T, B, S, E, H, P, A, Fn, K, int(USE_GRAPH),
        *(_ptr(w[k]) for k in ("attn_w", "attn_b", "dec_w", "dec_b", "query_w", "loc_w",
                               "loc_dense_w", "v")),
        _ptr(prenet_seq), _ptr(memory), _ptr(pmem), _ptr(add_mask), *(_ptr(m) for m in masks),
        _ptr(h_dec), _ptr(ctx), _ptr(wt), _ptr(g_att), _ptr(g_dec), _ptr(c_att), _ptr(c_dec),
        _ptr(h_att), _ptr(wcum), _ptr(zeros), *(_ptr(x) for x in (part, qpart, xa, xd)),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(err, "t2v_teacher_fwd")
    teacher_fwd.launches += 1
    return (h_dec, ctx, wt), (g_att, g_dec, c_att, c_dec, h_att)


def _run_bwd(w, memory, pmem, masks, dys, ys, resids, w_cum_prev):
    dev = memory.device
    T, B, S = ys[2].shape
    H, P, E, S, A, Fn, K = _dims(w, memory, pmem)
    sdt = w["attn_w"].dtype
    masks = _masks(masks, T, B, H, sdt)
    g_att, g_dec, c_att_prev, c_dec_prev, h_att = resids
    named = {"dh_dec": dys[0], "dctx": dys[1], "dw": dys[2], "g_att": g_att, "g_dec": g_dec,
             "c_att_prev": c_att_prev, "c_dec_prev": c_dec_prev, "h_att": h_att,
             "w_seq": ys[2], "w_cum_prev": w_cum_prev}
    for name, x in named.items():
        want = sdt if name in ("g_att", "g_dec") else torch.float32
        if x.dtype != want or x.shape[:2] != (T, B):
            raise ValueError(f"{name} must be (T, B, ...) in {want}")
    _check({**w, **named, "memory": memory, "pmem": pmem,
            **{f"m{i + 1}": m for i, m in enumerate(masks)}}, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dg_att = torch.empty(T, B, 4 * H, dtype=sdt, device=dev)
    dg_dec = torch.empty_like(dg_att)
    dpn, dctx = torch.empty(T, B, P, **f32), torch.empty(T, B, E, **f32)
    dloc = torch.empty(T, B, S, Fn, dtype=sdt, device=dev)
    dv, dwq, dwld = torch.empty(A, **f32), torch.zeros(H, A, **f32), torch.empty(Fn, A, **f32)
    dpmem = torch.zeros(B, S, A, **f32)
    sizes = bwd_work(B, S, E, H, P, A, Fn)
    work = torch.zeros(sum(sizes), **f32).split(sizes)
    tc = sdt != torch.float32
    part = torch.empty(0 if tc else SPLIT * B * max(2 * H + E, P + E + H), **f32)
    C = bwd_chunk(T, B, S, H, A, Fn, K)
    ring = _ring_tensor(C, B, S, H, A, Fn, K, dev)
    steps = ctypes.c_longlong(0)
    err = _fn("teacher_bwd", "t2v_teacher_bwd", 12, 46)(
        DTYPES[sdt], T, B, S, E, H, P, A, Fn, K, C, int(USE_GRAPH),
        *(_ptr(w[k]) for k in ("attn_w", "dec_w", "query_w", "loc_w", "loc_dense_w", "v")),
        _ptr(memory), _ptr(pmem), *(_ptr(m) for m in masks),
        *(_ptr(x) for x in named.values()),
        _ptr(dg_att), _ptr(dg_dec), _ptr(dpn), _ptr(dctx), _ptr(dloc), _ptr(dv), _ptr(dwq),
        _ptr(dwld), _ptr(dpmem), *(_ptr(x) for x in work), _ptr(part), _ptr(ring),
        ctypes.c_void_p(ctypes.addressof(steps)),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(err, "t2v_teacher_bwd")
    teacher_bwd.launches += 1
    teacher_bwd.coef_steps += steps.value
    profiling.count("teacher_bwd.coef_steps", steps.value)
    return dg_att, dg_dec, dpn, dctx, dloc, dv, dwq, dwld, dpmem


def _graph_counter(what: str) -> dict:
    out = {}
    for key, lib in (("K3", "teacher_fwd"), ("K4", "teacher_bwd")):
        fn = getattr(_build.load(lib), f"t2v_{lib}_graph_{what}")
        fn.restype, fn.argtypes = ctypes.c_int, []
        out[key] = fn()
    return out


def graph_captures() -> dict:
    """Step-loop CUDA graphs instantiated so far by K3 and K4 in this
    process: one per set of sizes not among the last ``GRAPHS``."""
    return _graph_counter("captures")


def graph_updates() -> dict:
    """Calls of K3 and K4 so far at known sizes with new pointers, whose
    graph was captured again and updated in place (no instantiation)."""
    return _graph_counter("updates")


def _build_ns(lib: str) -> int:
    fn = getattr(_build.load(lib), f"t2v_{lib}_graph_build_ns")
    fn.restype, fn.argtypes = ctypes.c_longlong, []
    return fn()


def graph_instantiate_ms() -> dict:
    """Host milliseconds K3 and K4 have spent so far building their
    step-loop graphs: capturing the loop, then instantiating it or updating
    a graph in place (two clock reads a build in the C code)."""
    return {key: _build_ns(lib) / 1e6 for key, lib in (("K3", "teacher_fwd"),
                                                        ("K4", "teacher_bwd"))}


def _counted(lib: str, run, *args):
    """``run(*args)``; while ``utils.profiling`` records, the graph build
    time of the call is added to the counter ``<lib>.instantiate_ns``."""
    if not profiling.recording():
        return run(*args)
    ns = _build_ns(lib)
    out = run(*args)
    profiling.count(f"{lib}.instantiate_ns", _build_ns(lib) - ns)
    return out


def teacher_fwd(w, prenet_seq, memory, pmem, add_mask, masks=None):
    """Forward recurrence (K3 on CUDA, the twin on the CPU).

    w: ``pack`` output; prenet_seq (T, B, P), memory (B, S, E), pmem
    (B, S, A), add_mask (B, S) float32; masks None (dropout off) or four
    pre-scaled (T, B, H) masks in the stream dtype."""
    if memory.is_cuda:
        return _counted("teacher_fwd", _run_fwd, w, prenet_seq, memory, pmem, add_mask, masks)
    if memory.device.type != "cpu":
        raise ValueError(f"teacher_fwd runs on CUDA or CPU, not {memory.device}")
    return teacher_fwd_plain(w, prenet_seq, memory, pmem, add_mask, masks)


def teacher_bwd(w, memory, pmem, masks, dys, ys, resids, w_cum_prev):
    """Reverse-time BPTT (K4 on CUDA, the twin on the CPU); see the module
    docstring for the returned streams and accumulators."""
    if memory.is_cuda:
        return _counted("teacher_bwd", _run_bwd, w, memory, pmem, masks, dys, ys, resids,
                        w_cum_prev)
    if memory.device.type != "cpu":
        raise ValueError(f"teacher_bwd runs on CUDA or CPU, not {memory.device}")
    return teacher_bwd_plain(w, memory, pmem, masks, dys, ys, resids, w_cum_prev)


teacher_fwd.launches = 0
teacher_bwd.launches = 0
teacher_bwd.coef_steps = 0
