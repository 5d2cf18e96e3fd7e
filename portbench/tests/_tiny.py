"""A cell of the benchmark at tiny widths, for runs on the CPU."""

from __future__ import annotations

import copy

from portbench import core

TINY_T2 = {"encoder_embedding_dim": 64, "symbols_embedding_dim": 64, "E": 64,
           "attention_rnn_dim": 64, "decoder_rnn_dim": 64, "prenet_dim": 32,
           "attention_dim": 32, "postnet_embedding_dim": 64, "ref_enc_gru_size": 32,
           "z_latent_dim": 8, "ref_enc_filters": [2, 2, 4, 4, 8, 8],
           "attention_location_n_filters": 8}
TINY_WG = {"n_flows": 4, "n_group": 8, "n_early_every": 2, "n_early_size": 2, "n_layers": 2,
           "n_channels": 8, "kernel_size": 3, "upsample_kernel": 1024, "upsample_stride": 256}


def tiny_spec(cell: str, dtype: str = "float32") -> dict:
    """The cell's spec with tiny widths, 12 decode steps (serving) or 12
    clips in batches of 4 (training)."""
    spec = copy.deepcopy(core.cell_spec(cell))
    sizes = spec["config"]["sizes"]
    sizes["tacotron2"].update(TINY_T2, compute_dtype=dtype)
    if "waveglow" in sizes:
        sizes["waveglow"] = dict(TINY_WG)
        sizes["max_decoder_steps"] = 12
    else:
        sizes["tacotron2"]["batch_size"] = 4
        sizes["tacotron2"]["num_workers"] = 1
        sizes["train_clips"] = 12
        spec["traffic"]["min_step_s"] = 0.5
    return spec
