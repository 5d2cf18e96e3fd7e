"""The benchmark's operation and byte counts against values worked by hand
at tiny sizes."""

import pytest

from portbench import counts

T2 = {"attention_rnn_dim": 4, "decoder_rnn_dim": 4, "prenet_dim": 2,
      "encoder_embedding_dim": 2, "attention_dim": 2, "attention_location_n_filters": 1,
      "attention_location_kernel_size": 3, "n_mel_channels": 2, "n_frames_per_step": 1,
      "encoder_kernel_size": 1, "encoder_n_convolutions": 1, "postnet_embedding_dim": 2,
      "postnet_kernel_size": 1, "postnet_n_convolutions": 2, "ref_enc_filters": [1],
      "E": 2, "z_latent_dim": 1, "compute_dtype": "bfloat16"}


def test_decoder_step_by_hand():
    # LSTMs: 16*(2+2+4) + 16*(4+2+4) = 288; projection 3*(4+2) = 18; prenet 2*2 + 2*2 = 8;
    # query 4*2 = 8  -> 322 multiply-adds; attention over S=3: 3*(2*3*1 + 1*2 + 2 + 2) = 36
    prod, att = counts.decoder_step_flops(T2, 3)
    assert prod == 2 * 322 and att == 2 * 36


def test_k1_bound_by_hand():
    # B=1, S=3, 1 step, bf16: operations 2 * (322 + 36) = 716 -> 716 / 989e12 s;
    # bytes: matrices 322 + loc 6 + dense 2 + v 2 = 332 elements * 2 B, biases
    # (16 + 16 + 3) * 4 B, io 1*3*(2+2)*2 + 3*4 + 1*(2+1+3)*4 -> 664+140+60 = 864 B
    want = max(864 / 3.35e12, 716 / 989e12)
    assert counts.k1_bound_s(T2, 1, 3, 1, "bfloat16") == pytest.approx(want)


def test_bound_takes_the_larger():
    assert counts.bound_s(3.35e12, {"float32": 67e12}) == 1.0
    assert counts.bound_s(0.0, {"bfloat16": 989e12, "float32": 67e12}) == 2.0


def test_waveglow_flops_by_hand():
    wg = {"n_flows": 1, "n_group": 2, "n_early_every": 4, "n_early_size": 2, "n_layers": 1,
          "n_channels": 1, "kernel_size": 1, "upsample_kernel": 1, "upsample_stride": 2}
    # T = 1 * 2 // 2 = 1; one flow of 2 channels, h = 1:
    # wavenet 2*(1 + 1*2*2*1 + 1*1*1*2 + 0 + 1 + 2) = 2*10; mixing 2*4; upsample 2*1*1*1
    wavenet, rest = counts.waveglow_flops(wg, 1, 1)
    assert wavenet == 20.0 and rest == 8.0 + 2.0


def test_encoder_and_postnet_by_hand():
    # one conv 2*S*D*D*K = 2*5*2*2*1 = 40; BiLSTM 2 dirs * 2*S*4H*(D+H), H = 1: 2*2*5*4*3 = 240
    assert counts.encoder_flops(T2, 5) == 280.0
    # 2*T*K*(M*C + 0 + C*M) = 2*3*1*(4 + 4) = 48
    assert counts.postnet_flops(T2, 3) == 48.0


def test_train_item_is_three_forwards():
    t2 = dict(T2, compute_dtype="float32")
    S, T = 3, 4
    prod, att = counts.decoder_step_flops(t2, S)
    fwd = (counts.encoder_flops(t2, S) + counts.vae_flops(t2, T) + T * prod
           + counts.postnet_flops(t2, T) + T * att)
    assert counts.train_item_peak_s(t2, S, T) == pytest.approx(3 * fwd / 67e12)
