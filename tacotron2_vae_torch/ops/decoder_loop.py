"""Decode-loop kernel K1 (``csrc/decoder_loop.cu``) and its plain twin.

``decode_loop`` runs the whole autoregressive Tacotron2 inference loop for
1 <= B <= 8 rows: prenet (dropout always on) -> attention LSTM ->
location-sensitive attention -> decoder LSTM -> fused mel+gate projection,
until every row's gate has fired or ``max_steps``.  On a CUDA tensor it
launches the hand-written kernel set (four kernels a step, looped on the
device by one CUDA graph per set of sizes and weights, reused across
calls); on a CPU tensor it runs ``decode_loop_plain``, the same loop in
PyTorch on the same packed weights, with the kernel's casting points and
its dropout hash.  It counts its calls of the kernel in
``decode_loop.launches`` and the launches of its tail kernel, which the
kernel counts on the device, in ``decode_loop.tail_launches``.  While
``utils.profiling`` records, each kernel call hands the enclosing span a
pair of CUDA events recorded around the head kernel and the graph's loop,
after any graph build (``device_events``), and the host time of its graph
build (``k1_instantiate_ns``, also summed in that counter).
``tail_step`` runs the tail kernel alone, once (``tail_step_plain`` on the
CPU), to hold it against its plain version.

Return contract (JAX ``decoder.infer``): mel (B, n_mel, max_steps*r),
gate (B, max_steps), alignments (B, max_steps, S), lengths (B,) in frames
including the step whose gate fired; rows emit zeros after they finish.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..utils import profiling
from . import _build

MAX_ROWS = 8          # rows one launch serves (the serving micro-batch cap)
CLUSTER = 8           # CTAs of the attention kernel's cluster per row (kNC in the source)
TAIL_CLUSTER = 8      # CTAs of the tail kernel's cluster (kTailNC in the source)
GRAPHS = 8            # executable graphs kept, one per set of sizes and weights (kDecodeGraphs)
UNROLL = 8            # steps in the body of the graph's device-side loop (kUnroll)
FLAGS = 16            # ints of the kernel's flags (kFlags; the tail's count in the last)
# True: the step loop runs as one cached CUDA graph that loops on the device;
# False: every step's kernels launch on the stream (the profiler sees each)
USE_GRAPH = True
# The weight dtypes' codes in ``t2v_decode_loop`` (the C side refuses any other)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_F32_MIN = float(np.finfo(np.float32).min)

# --------------------------------------------------------- dropout hash

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without int64 overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def dropout_bits(seed: int, step: int, layer: int, rows: int, units: int,
                 device=None) -> torch.Tensor:
    """(rows, units) uint32 values (as int64) of the kernel's counter hash,
    keyed on (seed, step, layer, row, unit)."""
    h = _mix32(torch.tensor((seed & _M32) ^ 0x9E3779B9, dtype=torch.int64,
                            device=device))
    h = _mix32(h ^ step)
    row = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    unit = torch.arange(units, dtype=torch.int64, device=device)[None, :]
    return _mix32(h ^ ((row * 2 + layer) * 65536 + unit))


def dropout_keep(seed: int, step: int, layer: int, rows: int, units: int,
                 device=None) -> torch.Tensor:
    """fp32 keep mask (1 keep / 0 drop) of rate-0.5 prenet dropout."""
    return (dropout_bits(seed, step, layer, rows, units, device)
            < 2 ** 31).float()


# ------------------------------------------------------------ packing


def pack_weights(dec, dtype=torch.float32) -> dict:
    """Pack a ``models.decoder.Decoder``'s weights for the kernel.

    LSTM weights become one (4H, in+H) matrix each with row 4*j+g holding
    gate g of unit j (one warp reads a unit's four rows); biases are the
    summed bi+bh in fp32, gate-major.  The prenet, query and projection
    weights keep PyTorch's (out, in) layout (a warp reads a row); the
    location conv is (K, 2, F) and loc_dense (F, A), read by a thread per
    filter / attention unit.  All matrices are cast to ``dtype``; biases
    stay fp32."""
    def cast(x):
        return x.detach().to(dtype).contiguous()

    def lstm(cell):
        w = torch.cat([cell.weight_ih, cell.weight_hh], dim=1)  # (4H, K)
        H = cell.weight_hh.shape[1]
        w = w.reshape(4, H, -1).transpose(0, 1).reshape(4 * H, -1)
        return cast(w), (cell.bias_ih + cell.bias_hh).detach().float().contiguous()

    att = dec.attention_layer
    loc = att.location_layer
    proj, gate = dec.linear_projection.linear_layer, dec.gate_layer.linear_layer
    att_w, att_b = lstm(dec.attention_rnn)
    dec_w, dec_b = lstm(dec.decoder_rnn)
    return {
        "w1": cast(dec.prenet.layers[0].linear_layer.weight),
        "w2": cast(dec.prenet.layers[1].linear_layer.weight),
        "att_w": att_w, "att_b": att_b, "dec_w": dec_w, "dec_b": dec_b,
        "wq": cast(att.query_layer.linear_layer.weight),
        "locw": cast(loc.location_conv.conv.weight.permute(2, 1, 0)),  # (K, 2, F)
        "ldw": cast(loc.location_dense.linear_layer.weight.t()),
        "v": cast(att.v.linear_layer.weight[0]),
        "pg_w": cast(torch.cat([proj.weight, gate.weight], 0)),
        "pg_b": torch.cat([proj.bias, gate.bias]).detach().float().contiguous(),
    }


def additive_mask(mask, B, S, device):
    """(B, S) fp32: 0 where attended, finfo(float32).min where masked."""
    if mask is None:
        return torch.zeros((B, S), dtype=torch.float32, device=device)
    return torch.where(mask.to(device), 0.0, _F32_MIN).float()


# ----------------------------------------------------------- plain twin


def decode_loop_plain(kw, memory, pmem, mask, *, max_steps: int,
                      gate_threshold: float, seed: int, dropout_on: bool = True):
    """The kernel's loop in PyTorch: same packed weights, casting points,
    dropout hash and early exit.  Returns the raw buffers
    (mel (max_steps, B, n_out), gate (max_steps, B),
    align (max_steps, B, S), steps)."""
    B, S, E = memory.shape
    dev = memory.device
    dt = kw["att_w"].dtype

    def c(x):
        return x.to(dt).float()

    f = {k: v.float() for k, v in kw.items()}
    mem = c(memory)
    pm = c(pmem)
    add = additive_mask(mask, B, S, dev)
    Ha = kw["att_w"].shape[0] // 4
    Hd = kw["dec_w"].shape[0] // 4
    n_out = kw["pg_w"].shape[0] - 1
    P = kw["w1"].shape[0]
    KL = kw["locw"].shape[0]
    pad = (KL - 1) // 2

    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731
    h_att, c_att, h_dec, c_dec = z(B, Ha), z(B, Ha), z(B, Hd), z(B, Hd)
    w_prev, w_cum, ctx = z(B, S), z(B, S), z(B, E)
    prev = z(B, n_out)
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    mel_buf, gate_buf, align_buf = z(max_steps, B, n_out), z(max_steps, B), z(max_steps, B, S)

    def lstm(x, w, b, cst):
        g = (c(x) @ w.t()).reshape(B, -1, 4) + b.reshape(4, -1).t()
        i, fg, gg, o = g.unbind(-1)
        cn = torch.sigmoid(fg) * cst + torch.sigmoid(i) * torch.tanh(gg)
        return torch.sigmoid(o) * torch.tanh(cn), cn

    t = 0
    while t < max_steps and not bool(finished.all()):
        x = torch.relu(c(prev) @ f["w1"].t())
        if dropout_on:
            x = x * dropout_keep(seed, t, 0, B, P, dev) * 2.0
        x = torch.relu(c(x) @ f["w2"].t())
        if dropout_on:
            x = x * dropout_keep(seed, t, 1, B, P, dev) * 2.0
        h_att, c_att = lstm(torch.cat([x, ctx, h_att], 1), f["att_w"], f["att_b"], c_att)

        wpad = torch.nn.functional.pad(c(torch.stack([w_prev, w_cum], 1)), (pad, KL - 1 - pad))
        locf = sum(wpad[:, :, k:k + S].transpose(1, 2) @ f["locw"][k] for k in range(KL))
        loc = c(locf) @ f["ldw"]                                  # (B, S, A)
        q = c(h_att) @ f["wq"].t()                               # (B, A)
        pre = torch.tanh(q[:, None, :] + loc + pm)
        e = c(pre) @ f["v"] + add
        w = torch.softmax(e, dim=1)
        ctx = (c(w)[:, None, :] @ mem)[:, 0]
        w_cum = w_cum + w
        w_prev = w

        h_dec, c_dec = lstm(torch.cat([h_att, ctx, h_dec], 1), f["dec_w"], f["dec_b"], c_dec)
        out = c(torch.cat([h_dec, ctx], 1)) @ f["pg_w"].t() + f["pg_b"]
        active = (~finished)[:, None]
        mel_buf[t] = torch.where(active, out[:, :n_out], 0.0)
        gate_buf[t] = torch.where(active[:, 0], out[:, n_out], 0.0)
        align_buf[t] = torch.where(active, w, 0.0)
        finished = finished | (torch.sigmoid(out[:, n_out]) > gate_threshold)
        prev = out[:, :n_out]
        t += 1
    return mel_buf, gate_buf, align_buf, t


def tail_step_plain(kw, xa, xd, xp, wprev, flags, mel, gate, align, *, max_steps: int,
                    gate_threshold: float, seed: int, dropout_on: bool = True):
    """What the tail kernel does at step t = flags[1], in PyTorch, in place:
    h_dec (the first Hd columns of xp = [h_dec, ctx]) into xd's last Hd
    columns, one more tail launch counted in flags[-1]; then, unless the
    decode has ended (flags[0]), the projection of xp rounded, the step's
    mel, gate and alignments (wprev) for rows not yet finished (flags[2 +
    b] == 0), the prenet of step t + 1 on the frame into xa's first P
    columns unless the decode stops here (every row finished, or t + 1 ==
    max_steps), and the flags: finished, step t + 1, done."""
    dev = xp.device
    dt = kw["att_w"].dtype
    B = xp.shape[0]
    P, n_out = kw["w1"].shape
    Hd = kw["dec_w"].shape[0] // 4

    def c(x):
        return x.to(dt).float()

    xd[:, xd.shape[1] - Hd:] = xp[:, :Hd]
    flags[FLAGS - 1] += 1
    t = int(flags[1])
    if int(flags[0]):
        return
    out = c(xp) @ kw["pg_w"].float().t() + kw["pg_b"]
    active = flags[2:2 + B] == 0
    mel[t] = torch.where(active[:, None], out[:, :n_out], mel[t])
    gate[t] = torch.where(active, out[:, n_out], gate[t])
    align[t] = torch.where(active[:, None], wprev, align[t])
    finished = ~active | (torch.sigmoid(out[:, n_out]) > gate_threshold)
    stop = bool(finished.all()) or t + 1 >= max_steps
    if not stop:
        x = torch.relu(c(out[:, :n_out]) @ kw["w1"].float().t())
        if dropout_on:
            x = x * dropout_keep(seed, t + 1, 0, B, P, dev) * 2.0
        x = torch.relu(c(x) @ kw["w2"].float().t())
        if dropout_on:
            x = x * dropout_keep(seed, t + 1, 1, B, P, dev) * 2.0
        xa[:, :P] = x
    flags[2:2 + B] = finished.int()
    flags[1] = t + 1
    flags[0] = int(stop)


def finish(mel_buf, gate_buf, align_buf, steps: int, gate_threshold: float,
           r: int):
    """Raw loop buffers -> the decoder.infer contract (lengths in frames)."""
    max_steps, _, n_out = mel_buf.shape
    fired = torch.sigmoid(gate_buf) > gate_threshold                 # (T, B)
    fired &= (torch.arange(max_steps, device=gate_buf.device) < steps)[:, None]
    any_fired = fired.any(0)
    first = fired.int().argmax(0)
    lengths = torch.where(any_fired, first + 1, torch.full_like(first, steps)) * r
    return (ungroup_mel(mel_buf, n_out // r, r), gate_buf.t().contiguous(),
            align_buf.transpose(0, 1).contiguous(), lengths)


def ungroup_mel(mel_out, n_mel: int, r: int):
    """(Tg, B, r*n_mel) time-major groups -> (B, n_mel, Tg*r) frames."""
    Tg, B, _ = mel_out.shape
    return (mel_out.reshape(Tg, B, r, n_mel).permute(1, 3, 0, 2)
            .reshape(B, n_mel, Tg * r))


# -------------------------------------------------------------- wrapper


def _ptr(x: torch.Tensor):
    return ctypes.c_void_p(x.data_ptr())


@lru_cache(maxsize=None)
def _kernel_fn():
    """``t2v_decode_loop`` with its C signature, resolved once."""
    fn = _build.load("decoder_loop").t2v_decode_loop
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 11 + [ctypes.c_void_p] * 18
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_uint, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p])
    return fn


INFO = ("graphs_instantiated", "max_persisting_l2_bytes", "max_window_bytes",
        "persisting_l2_limit", "windowed_lstm_nodes", "l2_setaside_bytes", "hit_ratio",
        "cuda_runtime", "cuda_driver", "instantiate_ns")


def info() -> dict:
    """The kernel's host-side state on the current card: graphs instantiated
    so far in this process (one per set of sizes and weights not among the
    last ``GRAPHS``), the card's largest persisting-L2 set-aside and access
    window, the persisting-L2 limit now (the decode restores it), the LSTM
    graph nodes that carry their window in the last graph built, the last
    decode's set-aside and hitRatio, the CUDA runtime's and driver's
    versions (conditional graph nodes need 12.3 or later), and the host
    nanoseconds spent capturing and instantiating graphs so far."""
    fn = _build.load("decoder_loop").t2v_decode_info
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_void_p, ctypes.c_int]
    out = (ctypes.c_longlong * len(INFO))()
    _build.check(fn(out, len(INFO)), "t2v_decode_info")
    vals = dict(zip(INFO, out))
    vals["hit_ratio"] /= 1e6
    return vals


def l2_window(kw) -> bool:
    """Whether a decode with the packed weights ``kw`` gives its LSTM
    launches an L2 access-policy window (and sets L2 aside for the decode):
    only where both LSTMs' weights exceed the card's L2.  At full width
    that is float32 (71.4 MB of 50 MB); bf16's 35.7 MB stay in L2 without
    it, and the window there did not pay (PERF.md)."""
    lstm_bytes = sum(kw[k].numel() * kw[k].element_size() for k in ("att_w", "dec_w"))
    return lstm_bytes > torch.cuda.get_device_properties(kw["att_w"].device).L2_cache_size


def graph_captures() -> int:
    """Decode graphs instantiated so far in this process."""
    return info()["graphs_instantiated"]


def _run_kernel(kw, memory, pmem, mask, *, max_steps, gate_threshold, seed,
                dropout_on):
    dev = memory.device
    dt = kw["att_w"].dtype
    B, S, E = memory.shape
    if not 1 <= B <= MAX_ROWS:
        raise ValueError(f"decode_loop serves 1..{MAX_ROWS} rows, got B={B}")
    if dt not in DTYPES:
        raise ValueError(f"decode_loop weights must be one of {list(DTYPES)}, got {dt}")
    for k, v in kw.items():
        if v.device != dev or not v.is_contiguous():
            raise ValueError(f"packed weight {k!r} must be contiguous on {dev}")
    Ha, Hd = kw["att_w"].shape[0] // 4, kw["dec_w"].shape[0] // 4
    P, n_in = kw["w1"].shape
    A = kw["wq"].shape[0]
    KL, _, F = kw["locw"].shape
    n_out = kw["pg_w"].shape[0] - 1
    vec = 16 // dt.itemsize
    for name, K in (("attention LSTM", P + E + Ha), ("decoder LSTM", Ha + E + Hd),
                    ("projection", Hd + E), ("query", Ha), ("prenet", n_in), ("prenet", P),
                    ("memory", E)):
        if K % vec:
            raise ValueError(f"{name} input width {K} must be a multiple of {vec}")
    if A % 32 or A % (4 * CLUSTER) or 256 % A or F > 32 or F % 4 or P % 16:
        raise ValueError(f"decode_loop needs attention_dim dividing 256 in multiples of 32 "
                         f"(and of 4 rows per CTA of the {CLUSTER}-CTA attention cluster), "
                         f"a multiple of 4 location filters up to 32, and prenet_dim % 16 == 0 "
                         f"(A={A}, F={F}, P={P})")
    if E > 1024 * CLUSTER:
        raise ValueError(f"decode_loop takes encoder_embedding_dim up to {1024 * CLUSTER} "
                         f"(4 per thread of each attention CTA), got E={E}")
    if n_in != n_out or pmem.shape != (B, S, A):
        raise ValueError("inconsistent decoder shapes for decode_loop")

    mem = memory.to(dt).contiguous()
    pm = pmem.to(dt).contiguous()
    add = additive_mask(mask, B, S, dev).contiguous()
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731
    mel_buf, gate_buf, align_buf = z(max_steps, B, n_out), z(max_steps, B), z(max_steps, B, S)
    counts = (ctypes.c_int * 2)()
    stream = torch.cuda.current_stream(dev).cuda_stream
    events, null = None, ctypes.c_void_p(0)
    if profiling.recording():
        built = info()["instantiate_ns"]
        events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for ev in events:   # creates the event, which the kernel's call records again
            ev.record()
    err = _kernel_fn()(
        DTYPES[dt], B, S, E, Ha, Hd, P, A, F, KL, n_out,
        *(_ptr(kw[k]) for k in ("w1", "w2", "att_w", "att_b", "dec_w", "dec_b",
                                "wq", "locw", "ldw", "v", "pg_w", "pg_b")),
        _ptr(mem), _ptr(pm), _ptr(add), _ptr(mel_buf), _ptr(gate_buf), _ptr(align_buf),
        max_steps, float(gate_threshold), seed & _M32, int(bool(dropout_on)),
        int(l2_window(kw)), int(bool(USE_GRAPH)), counts, ctypes.c_void_p(stream),
        *((ctypes.c_void_p(ev.cuda_event) for ev in events) if events else (null, null)))
    _build.check(err, "t2v_decode_loop")
    if events:
        built = info()["instantiate_ns"] - built
        profiling.count("k1.instantiate_ns", built)
        profiling.annotate(device_events=events, k1_instantiate_ns=built)
    decode_loop.launches += 1
    decode_loop.tail_launches += counts[1]
    return mel_buf, gate_buf, align_buf, counts[0]


def decode_loop(kw, memory, pmem, mask=None, *, max_steps: int,
                gate_threshold: float, seed: int, dropout_on: bool = True,
                r: int = 1):
    """Run the decode loop (kernel on CUDA, plain twin on CPU).

    kw: ``pack_weights`` output on the memory's device; memory (B, S, E);
    pmem (B, S, A) the fp32 processed memory (cast to the weight dtype
    here, as the TPU kernel does); mask (B, S) bool or None."""
    if memory.is_cuda:
        bufs = _run_kernel(kw, memory, pmem, mask, max_steps=max_steps,
                           gate_threshold=gate_threshold, seed=seed,
                           dropout_on=dropout_on)
    elif memory.device.type == "cpu":
        bufs = decode_loop_plain(kw, memory, pmem, mask, max_steps=max_steps,
                                 gate_threshold=gate_threshold, seed=seed,
                                 dropout_on=dropout_on)
    else:
        raise ValueError(f"decode_loop runs on CUDA or CPU, not {memory.device}")
    return finish(*bufs, gate_threshold, r)


def tail_step(kw, xa, xd, xp, wprev, flags, mel, gate, align, *, max_steps: int,
              gate_threshold: float, seed: int, dropout_on: bool = True):
    """The tail kernel alone, once, at step flags[1], in place: what
    ``tail_step_plain`` computes, which runs instead on CPU tensors.  It is
    the kernel's own check against its plain version, not a path of the
    decode.  kw: ``pack_weights`` output; float32 xa (B, P+E+Ha), xd (B,
    Ha+E+Hd), xp (B, Hd+E), wprev (B, S), mel (max_steps, B, n_out), gate
    (max_steps, B), align (max_steps, B, S); int32 flags (FLAGS,)."""
    if xp.device.type == "cpu":
        return tail_step_plain(kw, xa, xd, xp, wprev, flags, mel, gate, align,
                               max_steps=max_steps, gate_threshold=gate_threshold, seed=seed,
                               dropout_on=dropout_on)
    if not xp.is_cuda:
        raise ValueError(f"tail_step runs on CUDA or CPU, not {xp.device}")
    dt = kw["att_w"].dtype
    B, S = wprev.shape
    Ha, Hd = kw["att_w"].shape[0] // 4, kw["dec_w"].shape[0] // 4
    P, n_out = kw["w1"].shape
    E = xp.shape[1] - Hd
    want = {"xa": (xa, (B, P + E + Ha)), "xd": (xd, (B, Ha + E + Hd)), "xp": (xp, (B, Hd + E)),
            "wprev": (wprev, (B, S)), "mel": (mel, (max_steps, B, n_out)),
            "gate": (gate, (max_steps, B)), "align": (align, (max_steps, B, S))}
    for name, (x, shape) in want.items():
        if x.dtype != torch.float32 or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"tail_step: {name} must be contiguous float32 {shape}")
    if flags.dtype != torch.int32 or tuple(flags.shape) != (FLAGS,) or dt not in DTYPES:
        raise ValueError(f"tail_step: flags must be int32 ({FLAGS},), weights one of "
                         f"{list(DTYPES)}")
    fn = _build.load("decoder_loop").t2v_tail_step
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 8 + [ctypes.c_void_p] * 12
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_uint, ctypes.c_int, ctypes.c_void_p])
    err = fn(DTYPES[dt], B, S, E, Ha, Hd, P, n_out,
             *(_ptr(kw[k]) for k in ("w1", "w2", "pg_w", "pg_b")),
             *(_ptr(x) for x in (xa, xd, xp, wprev, flags, mel, gate, align)),
             max_steps, float(gate_threshold), seed & _M32, int(bool(dropout_on)),
             ctypes.c_void_p(torch.cuda.current_stream(xp.device).cuda_stream))
    _build.check(err, "t2v_tail_step")
    decode_loop.tail_launches += 1


decode_loop.launches = 0
decode_loop.tail_launches = 0
