"""BigVGAN's operation and byte counts, from the configuration's widths and
each call's padded mel frames (frozen here, as ``counts/__init__.py``'s).

The generator on ``frames`` mel frames: ``conv_pre`` (k 7), per stage i a
transposed convolution (C_i -> C_i / 2, kernel k_i, stride u_i) and one
AMPBlock1 per resblock kernel k (3 dilated and 3 plain convolutions of
C x C x k), ``conv_post`` (k 7, one channel).  Each AMPBlock1 has 6
anti-aliased activations (kernel K9), 18 a stage at 3 kernels, plus
``activation_post``: 109 launches a call at the published widths.

K9 on (C, L) float32 reads x and writes y once: 8 C L bytes.  Its
operations: per output sample, two upsampled samples of a 6-tap sum and a
scale (13 operations each), their SnakeBeta (a product, a sine counted as
one operation, a square, a product and a sum: 5 each) and a 12-tap sum
(24): ``K9_OPS_PER_SAMPLE`` = 60.
"""

from __future__ import annotations

from . import (HBM_BYTES_PER_S, PEAK, decoder_step_flops, encoder_flops, postnet_flops,
               vae_flops)

K9_OPS_PER_SAMPLE = 60


def stages(bv: dict, frames: int) -> list:
    """(channels, samples) after each stage's upsampling."""
    out, c, L = [], bv["upsample_initial_channel"], frames
    for u in bv["upsample_rates"]:
        c, L = c // 2, L * u
        out.append((c, L))
    return out


def k9_launches(bv: dict, frames: int) -> list:
    """(C, L) of every K9 launch of one generator call, in order."""
    per_block = 2 * len(bv["resblock_dilation_sizes"][0])
    shapes = []
    for c, L in stages(bv, frames):
        shapes += [(c, L)] * (per_block * len(bv["resblock_kernel_sizes"]))
    return shapes + [stages(bv, frames)[-1]]


def k9_bound_s(bv: dict, frames: int) -> float:
    """The sum of K9's bounds over one call: max(bytes / HBM rate,
    operations / float32 peak) a launch."""
    return sum(max(8.0 * C * L / HBM_BYTES_PER_S, K9_OPS_PER_SAMPLE * C * L / PEAK["float32"])
               for C, L in k9_launches(bv, frames))


def conv_flops(bv: dict, frames: int) -> float:
    """Operations (a multiply-add as two) of the generator's convolutions."""
    c0 = bv["upsample_initial_channel"]
    ops = 2.0 * frames * bv["num_mels"] * c0 * 7
    c_in, L_in = c0, frames
    for (c, L), k in zip(stages(bv, frames), bv["upsample_kernel_sizes"]):
        ops += 2.0 * L_in * c_in * c * k
        for kr, dil in zip(bv["resblock_kernel_sizes"], bv["resblock_dilation_sizes"]):
            ops += 2 * len(dil) * 2.0 * L * c * c * kr
        c_in, L_in = c, L
    return ops + 2.0 * L_in * c_in * 7


def k9_ops(bv: dict, frames: int) -> float:
    return float(sum(K9_OPS_PER_SAMPLE * C * L for C, L in k9_launches(bv, frames)))


def serve_request_peak_s(sizes: dict, S: int, frames: int, ref_frames: int,
                         mel_bucket: int) -> float:
    """Seconds one request's model operations take at the peak of their
    type: encoder, VAE (reference clip only), decode steps and postnet in
    the model's dtype (as ``counts.serve_request_peak_s``); BigVGAN's
    convolutions in the vocoder's dtype and K9's operations in float32, on
    the mel padded to the bucket."""
    t2 = sizes["tacotron2"]
    prod, att = decoder_step_flops(t2, S)
    model = (encoder_flops(t2, S) + (vae_flops(t2, ref_frames) if ref_frames else 0.0)
             + frames // t2["n_frames_per_step"] * (prod + att) + postnet_flops(t2, frames))
    padded = -(-frames // mel_bucket) * mel_bucket
    bv = sizes["bigvgan"]
    return (model / PEAK[t2["compute_dtype"]]
            + conv_flops(bv, padded) / PEAK[sizes.get("vocoder_dtype", "float32")]
            + k9_ops(bv, padded) / PEAK["float32"])
