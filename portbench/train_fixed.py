"""The training runner at one batch shape: ``train.run`` with the traffic's
``hparams`` (``fixed_batch_shapes``: every batch padded to the train set's
longest text and mel, rounded up to the buckets, as each rank of a
data-parallel run pads it).  The reference's batches, and the shapes the
set-up warms, are padded to the same (S, T), worked out from the corpus
as the program's loader works it out (``TextMelDataset.max_lengths``)."""

from __future__ import annotations

import os

from . import train
from .reference import loader


def run(spec: dict, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", hp_overrides: dict | None = None, **kw) -> dict:
    inner_plan, inner_shape = train.batch_plan, loader.batch_shape

    def batch_plan(flist, hpd, plan_seed, n_steps):
        entries = loader.read_filelist(flist)
        S = max(len(loader.tokens(e[1], hpd)) for e in entries)
        T = max((os.path.getsize(e[0]) - 44) // 2 // hpd["hop_length"] + 1 for e in entries)
        fixed = inner_shape([S], [T], hpd)[1:]
        loader.batch_shape = lambda tokens_len, frames, hp: (len(tokens_len),) + fixed
        return inner_plan(flist, hpd, plan_seed, n_steps)

    train.batch_plan = batch_plan
    try:
        return train.run(spec, seed, seconds, trace, t_start, device=device,
                         hp_overrides={**spec["traffic"]["hparams"], **(hp_overrides or {})},
                         **kw)
    finally:
        train.batch_plan, loader.batch_shape = inner_plan, inner_shape
