"""The benchmark's own operation and byte counts, from the configuration's
widths and each call's shapes (frozen here so that a change to the
program cannot move the yardstick).

A bound is the least time the card could take: the larger of the bytes
over the HBM rate (each input read once, each output written once) and
the operations over the peak rate of their type.  H100 SXM published
dense peaks: 989 TFLOP/s bfloat16 and float16, 67 TFLOP/s float32 outside
the tensor cores, 3.35 TB/s of HBM.  Every count reckons the work the
inputs need, whatever implements it.  Operations count a multiply-add as
two.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}


def itemsize(dtype_name: str) -> int:
    return 4 if dtype_name == "float32" else 2


def bound_s(n_bytes: float, ops_by_dtype: dict) -> float:
    """max(bytes / HBM rate, sum of operations / the peak of their type)."""
    return max(n_bytes / HBM_BYTES_PER_S, sum(o / PEAK[d] for d, o in ops_by_dtype.items()))


def _w(t2: dict) -> dict:
    n_out = t2["n_mel_channels"] * t2["n_frames_per_step"]
    return {"Ha": t2["attention_rnn_dim"], "Hd": t2["decoder_rnn_dim"], "P": t2["prenet_dim"],
            "E": t2["encoder_embedding_dim"], "A": t2["attention_dim"],
            "F": t2["attention_location_n_filters"], "K": t2["attention_location_kernel_size"],
            "n_out": n_out}


def k1_bound_s(t2: dict, B: int, S: int, steps: int, dtype_name: str) -> float:
    """The decode loop K1 on (B, S) for ``steps`` steps: its weights (the
    matrices in the dtype, the biases in float32) read once, its memory,
    keys and mask read and its frames, gates and alignments written, or
    its products at the dtype's peak (``chip_smoke.k1_bound``)."""
    w = _w(t2)
    Ha, Hd, P, E, A, F, K, n_out = (w[k] for k in ("Ha", "Hd", "P", "E", "A", "F", "K",
                                                  "n_out"))
    mats = (4 * Ha * (P + E + Ha) + 4 * Hd * (Ha + E + Hd) + (n_out + 1) * (Hd + E)
            + P * n_out + P * P + A * Ha + K * 2 * F + F * A + A)
    weight_bytes = mats * itemsize(dtype_name) + 4 * (4 * Ha + 4 * Hd + n_out + 1)
    io_bytes = (B * S * (E + A) * itemsize(dtype_name) + B * S * 4
                + steps * B * (n_out + 1 + S) * 4)
    macs = (4 * Ha * (P + E + Ha) + 4 * Hd * (Ha + E + Hd) + (n_out + 1) * (Hd + E)
            + n_out * P + P * P + Ha * A + S * (2 * K * F + F * A + A + E))
    return bound_s(weight_bytes + io_bytes, {dtype_name: 2.0 * macs * B * steps})


def _scan_weight_bytes(t2: dict, dtype_name: str) -> int:
    w = _w(t2)
    H, P, E, A, F, K = w["Ha"], w["P"], w["E"], w["A"], w["F"], w["K"]
    lstm = ((P + E + H) + (H + E + H)) * 4 * H * itemsize(dtype_name)
    return lstm + 4 * (8 * H + H * A + K * 2 * F + F * A + A)


def k3_bound_s(t2: dict, B: int, S: int, T: int, dtype_name: str, masks: bool) -> float:
    """One K3 call (the teacher-forced recurrence forward): the LSTM
    products at the stream dtype's peak plus the float32 attention at the
    float32 peak, against every input read once and every output written
    once (``chip_smoke.k3_bound``)."""
    w = _w(t2)
    H, P, E, A, F, K = w["Ha"], w["P"], w["E"], w["A"], w["F"], w["K"]
    H4, it = 4 * H, itemsize(dtype_name)
    lstm = 2.0 * T * B * ((P + E + H) + (H + E + H)) * H4
    att = 2.0 * T * B * (H * A + S * (2 * K * F + F * A + A + E))
    io = 4 * (T * B * P + B * S * (E + A + 1)) + (4 * T * B * H * it if masks else 0)
    out = 4 * T * B * (4 * H + E + S) + 2 * T * B * H4 * it
    return bound_s(_scan_weight_bytes(t2, dtype_name) + io + out,
                   {dtype_name: lstm, "float32": att})


def k4_bound_s(t2: dict, B: int, S: int, T: int, dtype_name: str, masks: bool) -> float:
    """One K4 call (the recurrence backward), counted as ``k3_bound_s``:
    the two input-gradient products, the attention recompute and its
    backward (``chip_smoke.k4_bound``)."""
    w = _w(t2)
    H, P, E, A, F, K = w["Ha"], w["P"], w["E"], w["A"], w["F"], w["K"]
    H4, it = 4 * H, itemsize(dtype_name)
    lstm = 2.0 * T * B * ((P + E + H) + (H + E + H)) * H4
    att = 2.0 * T * B * (2 * H * A + S * (4 * K * F + 3 * F * A + 3 * A + 2 * E))
    io = (4 * (B * S * (E + A) + T * B * (H + E + S) + T * B * (3 * H + 2 * S))
          + 2 * T * B * H4 * it + (4 * T * B * H * it if masks else 0))
    out = (2 * T * B * H4 + T * B * S * F) * it + 4 * (T * B * (P + E) + B * S * A
                                                        + H * A + F * A + A)
    return bound_s(_scan_weight_bytes(t2, dtype_name) + io + out,
                   {dtype_name: lstm, "float32": att})


def waveglow_flops(wg: dict, n_mel: int, frames: int) -> tuple:
    """(WaveNet, the rest) operations of one WaveGlow inverse on ``frames``
    mel frames: the WaveNet convolutions; the upsampler and the 1x1 flow
    mixing (``chip_smoke.waveglow_flops``)."""
    T = frames * wg["upsample_stride"] // wg["n_group"]
    nc, L, K = wg["n_channels"], wg["n_layers"], wg["kernel_size"]
    chans, c = [], wg["n_group"]
    for k in range(wg["n_flows"]):
        if k % wg["n_early_every"] == 0 and k > 0:
            c -= wg["n_early_size"]
        chans.append(c)
    wavenet = mixing = 0
    for c in chans:
        h = c // 2
        wavenet += 2 * T * (h * nc + n_mel * wg["n_group"] * 2 * nc * L
                            + L * K * nc * 2 * nc + (L - 1) * nc * 2 * nc + nc * nc + nc * 2 * h)
        mixing += 2 * T * c * c
    up = 2 * frames * n_mel ** 2 * wg["upsample_kernel"]
    return float(wavenet), float(mixing + up)


def encoder_flops(t2: dict, S: int) -> float:
    D, K = t2["encoder_embedding_dim"], t2["encoder_kernel_size"]
    H = D // 2
    return (t2["encoder_n_convolutions"] * 2.0 * S * D * D * K
            + 2 * 2.0 * S * 4 * H * (D + H))


def vae_flops(t2: dict, T: int) -> float:
    """The reference encoder (six stride-2 3x3 convolutions, the first
    with three coordinate channels, then a GRU) and its heads on T frames."""
    filters = [1] + list(t2["ref_enc_filters"])
    h, w, ops = T, t2["n_mel_channels"], 0.0
    for i in range(len(filters) - 1):
        h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        c_in = filters[i] + (3 if i == 0 else 0)
        ops += 2.0 * h * w * filters[i + 1] * c_in * 9
    G = t2["E"] // 2
    ops += 2.0 * h * 3 * G * (filters[-1] * w + G)
    z = t2["z_latent_dim"]
    return ops + 2.0 * (2 * G * z + z * t2["E"])


def decoder_step_flops(t2: dict, S: int) -> tuple:
    """(products, attention) operations of one decoder step of one row."""
    w = _w(t2)
    Ha, Hd, P, E, A, F, K, n_out = (w[k] for k in ("Ha", "Hd", "P", "E", "A", "F", "K",
                                                  "n_out"))
    prod = 2.0 * (4 * Ha * (P + E + Ha) + 4 * Hd * (Ha + E + Hd) + (n_out + 1) * (Hd + E)
                  + n_out * P + P * P + Ha * A)
    return prod, 2.0 * S * (2 * K * F + F * A + A + E)


def postnet_flops(t2: dict, T: int) -> float:
    C, K, n = t2["postnet_embedding_dim"], t2["postnet_kernel_size"], t2["postnet_n_convolutions"]
    M = t2["n_mel_channels"]
    return 2.0 * T * K * (M * C + (n - 2) * C * C + C * M)


def serve_request_peak_s(sizes: dict, S: int, frames: int, ref_frames: int,
                         mel_bucket: int) -> float:
    """Seconds one request's model operations take at the peak of their
    type: encoder, VAE (reference clip only), decode steps, postnet in the
    model's dtype; WaveGlow in the vocoder's."""
    t2 = sizes["tacotron2"]
    dt = t2["compute_dtype"]
    prod, att = decoder_step_flops(t2, S)
    model = (encoder_flops(t2, S) + (vae_flops(t2, ref_frames) if ref_frames else 0.0)
             + frames // t2["n_frames_per_step"] * (prod + att) + postnet_flops(t2, frames))
    padded = -(-frames // mel_bucket) * mel_bucket
    wavenet, rest = waveglow_flops(sizes["waveglow"], t2["n_mel_channels"], padded)
    vdt = sizes.get("vocoder_dtype", "float32")
    return model / PEAK[dt] + wavenet / PEAK[vdt] + rest / PEAK["float32"]


def train_item_peak_s(t2: dict, S: int, T: int) -> float:
    """Seconds one training item's forward and backward (twice the
    forward) take at the peak of their type: the products in the compute
    dtype, the recurrence's attention in float32."""
    dt = t2["compute_dtype"]
    prod, att = decoder_step_flops(t2, S)
    steps = T // t2["n_frames_per_step"]
    fwd_lo = encoder_flops(t2, S) + vae_flops(t2, T) + steps * prod + postnet_flops(t2, T)
    return 3.0 * (fwd_lo / PEAK[dt] + steps * att / PEAK["float32"])
