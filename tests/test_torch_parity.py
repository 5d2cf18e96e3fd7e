"""End-to-end numerical parity against a PyTorch oracle.

Builds a torch module tree with the *reference's* state_dict names
(model.py / modules.py / layers.py structure), runs a CPU-friendly
transcription of the reference's teacher-forced forward in eval mode
(dropout off, BN eval, VAE z=mu), converts the state_dict with
tools/convert_torch_ckpt.py, and checks this framework's forward matches.

This validates both the model math and the checkpoint converter: a real
trained reference checkpoint goes through exactly this path.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn as nn
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from tacotron2_vae_tpu.config import create_hparams

import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from convert_torch_ckpt import convert_tacotron2
from _torch_port_common import one_thread  # noqa: F401 (autouse)

HP = create_hparams(
    "symbols_embedding_dim=32,encoder_embedding_dim=32,"
    "attention_rnn_dim=24,decoder_rnn_dim=24,prenet_dim=16,attention_dim=12,"
    "postnet_embedding_dim=16,E=32,ref_enc_gru_size=16,z_latent_dim=4,"
    "ref_enc_filters=[2,2,4,4,8,8],attention_location_n_filters=4,"
    "attention_location_kernel_size=31,compute_dtype='float32'"
)


def build_torch_model(hp, seed=0):
    """Torch modules named exactly like the reference state_dict."""
    torch.manual_seed(seed)
    D = hp.encoder_embedding_dim

    class LinWrap(nn.Module):
        def __init__(self, i, o, bias=True):
            super().__init__()
            self.linear_layer = nn.Linear(i, o, bias=bias)

        def forward(self, x):
            return self.linear_layer(x)

    class ConvWrap(nn.Module):
        def __init__(self, i, o, k, bias=True):
            super().__init__()
            self.conv = nn.Conv1d(i, o, k, padding=(k - 1) // 2, bias=bias)

        def forward(self, x):
            return self.conv(x)

    class CoordConvWrap(nn.Module):
        def __init__(self, i, o):
            super().__init__()
            self.conv = nn.Conv2d(i + 3, o, 3, stride=2, padding=1)

        def forward(self, x):
            return self.conv(x)

    m = nn.Module()
    m.transcript_embedding = nn.Embedding(hp.n_symbols, D)
    m.speaker_embedding = LinWrap(hp.n_speakers, hp.speaker_embedding_dim)
    m.emotion_embedding = LinWrap(hp.n_emotions, hp.emotion_embedding_dim)

    enc = nn.Module()
    enc.convolutions = nn.ModuleList(
        [
            nn.Sequential(ConvWrap(D, D, hp.encoder_kernel_size), nn.BatchNorm1d(D))
            for _ in range(hp.encoder_n_convolutions)
        ]
    )
    enc.lstm = nn.LSTM(D, D // 2, 1, batch_first=True, bidirectional=True)
    m.encoder = enc

    dec = nn.Module()
    pre = nn.Module()
    pre.layers = nn.ModuleList(
        [
            LinWrap(hp.n_mel_channels, hp.prenet_dim, bias=False),
            LinWrap(hp.prenet_dim, hp.prenet_dim, bias=False),
        ]
    )
    dec.prenet = pre
    dec.attention_rnn = nn.LSTMCell(hp.prenet_dim + D, hp.attention_rnn_dim)
    att = nn.Module()
    att.query_layer = LinWrap(hp.attention_rnn_dim, hp.attention_dim, bias=False)
    att.memory_layer = LinWrap(D, hp.attention_dim, bias=False)
    att.v = LinWrap(hp.attention_dim, 1, bias=False)
    loc = nn.Module()
    loc.location_conv = ConvWrap(2, hp.attention_location_n_filters,
                                 hp.attention_location_kernel_size, bias=False)
    loc.location_dense = LinWrap(hp.attention_location_n_filters,
                                 hp.attention_dim, bias=False)
    att.location_layer = loc
    dec.attention_layer = att
    dec.decoder_rnn = nn.LSTMCell(hp.attention_rnn_dim + D, hp.decoder_rnn_dim)
    dec.linear_projection = LinWrap(hp.decoder_rnn_dim + D, hp.n_mel_channels)
    dec.gate_layer = LinWrap(hp.decoder_rnn_dim + D, 1)
    m.decoder = dec

    post = nn.Module()
    convs = []
    dims = ([hp.n_mel_channels] + [hp.postnet_embedding_dim]
            * (hp.postnet_n_convolutions - 1) + [hp.n_mel_channels])
    for i in range(hp.postnet_n_convolutions):
        convs.append(
            nn.Sequential(
                ConvWrap(dims[i], dims[i + 1], hp.postnet_kernel_size),
                nn.BatchNorm1d(dims[i + 1]),
            )
        )
    post.convolutions = nn.ModuleList(convs)
    m.postnet = post

    vae = nn.Module()
    ref = nn.Module()
    filters = [1] + list(hp.ref_enc_filters)
    rconvs = [CoordConvWrap(filters[0], filters[1])]
    for i in range(1, len(hp.ref_enc_filters)):
        rconvs.append(nn.Conv2d(filters[i], filters[i + 1], 3, stride=2, padding=1))
    ref.convs = nn.ModuleList(rconvs)
    ref.bns = nn.ModuleList([nn.BatchNorm2d(f) for f in hp.ref_enc_filters])
    out_freq = hp.n_mel_channels
    for _ in hp.ref_enc_filters:
        out_freq = (out_freq - 3 + 2) // 2 + 1
    ref.gru = nn.GRU(hp.ref_enc_filters[-1] * out_freq, hp.E // 2, batch_first=True)
    vae.ref_encoder = ref
    vae.fc1 = nn.Linear(hp.ref_enc_gru_size, hp.z_latent_dim)
    vae.fc2 = nn.Linear(hp.ref_enc_gru_size, hp.z_latent_dim)
    vae.fc3 = nn.Linear(hp.z_latent_dim, hp.E)
    m.vae_gst = vae
    return m


def torch_forward(m, hp, text, lengths, mel, raw_layout=False):
    """CPU transcription of the reference teacher-forced forward, eval mode
    (model.py:522-547 with dropout off, z=mu).

    raw_layout=True feeds the VAE encoder the reference's ACTUAL input —
    the raw-memory ``view(N, 1, -1, n_mels)`` of the (B, n_mel, T) mel
    (modules.py:67), which scrambles channel/time; False uses the corrected
    transpose this framework defaults to (config.ref_enc_raw_reshape doc).
    """
    m.eval()
    with torch.no_grad():
        B, S = text.shape
        T = mel.shape[2]
        emb = m.transcript_embedding(text)  # (B, S, D)

        # Encoder (model.py:175-192), dropout off.
        x = emb.transpose(1, 2)
        for conv in m.encoder.convolutions:
            x = F.relu(conv(x))
        x = x.transpose(1, 2)
        packed = nn.utils.rnn.pack_padded_sequence(x, lengths, batch_first=True)
        out, _ = m.encoder.lstm(packed)
        transcript, _ = nn.utils.rnn.pad_packed_sequence(out, batch_first=True)

        # VAE-GST (modules.py:24-31, 65-80), eval: z = mu.
        if raw_layout:
            inp = mel.contiguous().view(B, 1, -1, hp.n_mel_channels)
        else:
            inp = mel.transpose(1, 2).contiguous().view(B, 1, T, hp.n_mel_channels)
        o = inp
        for i, (conv, bn) in enumerate(zip(m.vae_gst.ref_encoder.convs,
                                           m.vae_gst.ref_encoder.bns)):
            if i == 0:
                # AddCoords rank-2 with_r (CoordConv.py:37-74)
                _, _, H, W = o.shape
                rows = torch.arange(H).float()[None, None, :, None].expand(1, 1, H, W)
                cols = torch.arange(W).float()[None, None, None, :].expand(1, 1, H, W)
                rows = rows / max(H - 1, 1) * 2 - 1
                cols = cols / max(W - 1, 1) * 2 - 1
                rows = rows.expand(B, 1, H, W)
                cols = cols.expand(B, 1, H, W)
                rr = torch.sqrt((rows - 0.5) ** 2 + (cols - 0.5) ** 2)
                o = torch.cat([o, rows, cols, rr], dim=1)
            o = F.relu(bn(conv(o)))
        o = o.transpose(1, 2).contiguous().view(B, o.shape[2], -1)
        _, h = m.vae_gst.ref_encoder.gru(o)
        enc_out = h.squeeze(0)
        mu = m.vae_gst.fc1(enc_out)
        logvar = m.vae_gst.fc2(enc_out)
        style = m.vae_gst.fc3(mu)

        memory = transcript + style.unsqueeze(1).expand_as(transcript)

        # Decoder (model.py:391-426), dropout off.
        processed_memory = m.decoder.attention_layer.memory_layer.linear_layer(memory)
        mask = torch.arange(S)[None, :] >= torch.as_tensor(lengths)[:, None]

        dec_in = torch.cat(
            [torch.zeros(B, 1, hp.n_mel_channels), mel.transpose(1, 2)[:, :-1]],
            dim=1,
        )
        pn = dec_in
        for layer in m.decoder.prenet.layers:
            pn = F.relu(layer.linear_layer(pn))

        h_att = torch.zeros(B, hp.attention_rnn_dim)
        c_att = torch.zeros(B, hp.attention_rnn_dim)
        h_dec = torch.zeros(B, hp.decoder_rnn_dim)
        c_dec = torch.zeros(B, hp.decoder_rnn_dim)
        attn_w = torch.zeros(B, S)
        attn_cum = torch.zeros(B, S)
        context = torch.zeros(B, transcript.shape[2])
        mels, gates, aligns = [], [], []
        for t in range(T):
            cell_in = torch.cat([pn[:, t], context], dim=1)
            h_att, c_att = m.decoder.attention_rnn(cell_in, (h_att, c_att))
            cat = torch.stack([attn_w, attn_cum], dim=1)  # (B, 2, S)
            loc = m.decoder.attention_layer.location_layer.location_conv.conv(cat)
            loc = m.decoder.attention_layer.location_layer.location_dense.linear_layer(
                loc.transpose(1, 2)
            )
            q = m.decoder.attention_layer.query_layer.linear_layer(h_att).unsqueeze(1)
            e = m.decoder.attention_layer.v.linear_layer(
                torch.tanh(q + loc + processed_memory)
            ).squeeze(-1)
            e = e.masked_fill(mask, -float("inf"))
            w = torch.softmax(e, dim=1)
            context = torch.bmm(w.unsqueeze(1), memory).squeeze(1)
            attn_cum = attn_cum + w
            attn_w = w
            h_dec, c_dec = m.decoder.decoder_rnn(
                torch.cat([h_att, context], dim=1), (h_dec, c_dec)
            )
            hc = torch.cat([h_dec, context], dim=1)
            mels.append(m.decoder.linear_projection.linear_layer(hc))
            gates.append(m.decoder.gate_layer.linear_layer(hc).squeeze(-1))
            aligns.append(w)
        mel_out = torch.stack(mels, dim=2)  # (B, n_mel, T)
        gate_out = torch.stack(gates, dim=1)
        align = torch.stack(aligns, dim=1)

        # Postnet (model.py:143-148), dropout off.
        p = mel_out
        for i, conv in enumerate(m.postnet.convolutions):
            p = conv(p)
            if i < len(m.postnet.convolutions) - 1:
                p = torch.tanh(p)
        mel_post = mel_out + p

    return (mel_out.numpy(), mel_post.numpy(), gate_out.numpy(),
            align.numpy(), mu.numpy(), logvar.numpy())


@pytest.mark.parametrize("raw_layout", [False, True],
                         ids=["corrected_layout", "reference_raw_reshape"])
def test_full_forward_parity(raw_layout):
    """raw_layout=True is the path a CONVERTED upstream checkpoint takes:
    torch oracle uses the reference's actual raw view(N,1,-1,n_mels) input
    and the JAX side sets ref_enc_raw_reshape=True."""
    hp = HP
    B, S, T = 2, 11, 128
    tm = build_torch_model(hp)
    rng = np.random.RandomState(0)
    text_np = rng.randint(2, hp.n_symbols, size=(B, S)).astype(np.int64)
    lengths = [S, S - 3]
    text_np[1, S - 3:] = 0
    mel_np = (rng.randn(B, hp.n_mel_channels, T) * 0.5).astype(np.float32)

    ref = torch_forward(
        tm, hp, torch.from_numpy(text_np), lengths, torch.from_numpy(mel_np),
        raw_layout=raw_layout,
    )

    params, model_state = convert_tacotron2(
        {k: v.numpy() for k, v in tm.state_dict().items()}, hp
    )
    from tacotron2_vae_tpu.models import tacotron2

    hp_nomask = hp.replace(mask_padding=False,
                           ref_enc_raw_reshape=raw_layout)
    batch = {
        "text": jnp.asarray(text_np.astype(np.int32)),
        "input_lengths": jnp.asarray(np.asarray(lengths, np.int32)),
        "mel": jnp.asarray(mel_np),
        "output_lengths": None,
        "emotions": jnp.zeros((B, hp.n_emotions)),
    }
    out, _ = tacotron2.forward(
        params, model_state, batch, hp_nomask, train=False,
        rng=jax.random.PRNGKey(0), prenet_dropout_enabled=False,
    )

    np.testing.assert_allclose(np.asarray(out.mu), ref[4], atol=1e-4)
    if raw_layout:
        # Sanity: the two layouts genuinely differ — the flag is load-bearing
        # for converted checkpoints (advisor finding, modules.py:67).
        ref_fixed = torch_forward(
            tm, hp, torch.from_numpy(text_np), lengths,
            torch.from_numpy(mel_np), raw_layout=False,
        )
        assert not np.allclose(ref[4], ref_fixed[4], atol=1e-4)
    np.testing.assert_allclose(np.asarray(out.logvar), ref[5], atol=1e-4)
    np.testing.assert_allclose(np.asarray(out.alignments), ref[3], atol=2e-4)
    np.testing.assert_allclose(np.asarray(out.gate_outputs), ref[2], atol=2e-3)
    np.testing.assert_allclose(np.asarray(out.mel_outputs), ref[0], atol=2e-3)
    np.testing.assert_allclose(np.asarray(out.mel_outputs_postnet), ref[1],
                               atol=5e-3)


@pytest.mark.slow
def test_full_size_forward_parity():
    """Production-width spot check (512-d embeddings, 1024-wide LSTM cells,
    512-ch postnet, full VAE filter stack): dtype/accumulation effects scale
    with width, so toy-dim parity alone is not sufficient evidence.  Short
    sequences keep the CPU oracle affordable; tolerances are wider than the
    toy test because ~1e5-element dot products accumulate more rounding."""
    hp = create_hparams("compute_dtype='float32'")  # flagship dims
    B, S, T = 2, 12, 80
    tm = build_torch_model(hp, seed=1)
    rng = np.random.RandomState(1)
    text_np = rng.randint(2, hp.n_symbols, size=(B, S)).astype(np.int64)
    lengths = [S, S - 4]
    text_np[1, S - 4:] = 0
    mel_np = (rng.randn(B, hp.n_mel_channels, T) * 0.5).astype(np.float32)

    ref = torch_forward(
        tm, hp, torch.from_numpy(text_np), lengths, torch.from_numpy(mel_np)
    )
    params, model_state = convert_tacotron2(
        {k: v.numpy() for k, v in tm.state_dict().items()}, hp
    )
    from tacotron2_vae_tpu.models import tacotron2

    batch = {
        "text": jnp.asarray(text_np.astype(np.int32)),
        "input_lengths": jnp.asarray(np.asarray(lengths, np.int32)),
        "mel": jnp.asarray(mel_np),
        "output_lengths": None,
        "emotions": jnp.zeros((B, hp.n_emotions)),
    }
    out, _ = tacotron2.forward(
        params, model_state, batch, hp.replace(mask_padding=False),
        train=False, rng=jax.random.PRNGKey(0), prenet_dropout_enabled=False,
    )
    np.testing.assert_allclose(np.asarray(out.mu), ref[4], atol=5e-4)
    np.testing.assert_allclose(np.asarray(out.logvar), ref[5], atol=5e-4)
    np.testing.assert_allclose(np.asarray(out.alignments), ref[3], atol=1e-3)
    np.testing.assert_allclose(np.asarray(out.gate_outputs), ref[2], atol=1e-2)
    np.testing.assert_allclose(np.asarray(out.mel_outputs), ref[0], atol=1e-2)
    np.testing.assert_allclose(np.asarray(out.mel_outputs_postnet), ref[1],
                               atol=2e-2)
