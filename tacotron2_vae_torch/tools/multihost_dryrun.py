"""One rank of a (data, model) grid of the port, on a tiny corpus or a saved batch.

The port's counterpart of the JAX package's ``tools/multihost_dryrun.py``:
it exercises what one process cannot, the process group's rendezvous, the
loader's per-rank shards, global batchnorm statistics and random draws,
the gradient all-reduce and, with ``--hparams mesh_model=M``, the tensor-
parallel model axis.  Launch it once per rank with torchrun:

    python -m tacotron2_vae_torch.tools.multihost_dryrun --make-corpus --workdir W
    torchrun --standalone --nproc_per_node=2 \\
        -m tacotron2_vae_torch.tools.multihost_dryrun --workdir W --device cpu

Without ``--batch`` each rank runs ``training.train.train`` on the corpus
in ``W`` (tiny widths, ``fixed_batch_shapes``, batch 4 over the ranks) and
prints ``DRYRUN {json}`` with its rank, world and iteration count; rank 0
prints the ``Train loss`` lines.  With ``--batch B.npz`` each rank takes its
rows of that global batch and takes ``--steps`` train steps on them
(``make_train_step`` on the grid), from the state dict
``--init`` when given; rank 0 writes the per-step losses, gradient norms
and logical gradients and the first and final logical state dicts to
``--out``.  With ``--waveglow`` the batch holds ``audio`` and ``mel`` and
the ranks take WaveGlow steps (``make_waveglow_train_step``, the
``--wg-config`` JSON over the default config, ``--mesh-model`` ranks a
row, Adam at 1e-4 after ``--clip``).  Each rank reports the bytes of its parameters and Adam moments.
Without torchrun's environment it is one process on the whole batch, the
reference the ranks are held against.  ``--backend gloo`` lets two ranks
share one card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

TINY = ("symbols_embedding_dim=32,encoder_embedding_dim=32,attention_rnn_dim=32,"
        "decoder_rnn_dim=32,prenet_dim=16,attention_dim=16,postnet_embedding_dim=32,E=32,"
        "ref_enc_gru_size=16,z_latent_dim=4,ref_enc_filters=[2,2,4,4,8,8],"
        "attention_location_n_filters=4,encoder_n_convolutions=2,postnet_n_convolutions=3,"
        "compute_dtype='float32'")
CORPUS = ("batch_size=4,anneal_function='constant',text_bucket_size=8,mel_bucket_size=16,"
          "epochs=2,iters_per_checkpoint=10000,fixed_batch_shapes=True")
TEXTS = ["감정있는 한국어 목소리", "안녕하세요 반갑습니다", "오늘 날씨가 좋네요",
         "테스트 문장입니다", "다중 호스트 학습", "데이터 병렬 처리", "멜 캐시 샤딩",
         "쿠다 네이티브"]


def make_corpus(workdir: str) -> str:
    """Eight 16 kHz clips of 0.25-0.45 s and their filelist ``train.txt``."""
    from ..dsp.audio import save_wav

    os.makedirs(workdir, exist_ok=True)
    rng = np.random.RandomState(0)
    lines = []
    for i, text in enumerate(TEXTS):
        n = 4000 + 800 * (i % 4)
        wav = (0.3 * np.sin(2 * np.pi * 220 * (i + 1) * np.arange(n) / 16000)
               + 0.01 * rng.randn(n)).astype(np.float32)
        path = os.path.join(workdir, f"utt_{i}.wav")
        save_wav(path, wav, 16000)
        lines.append(f"{path}|{text}|0|{i % 4}")
    flist = os.path.join(workdir, "train.txt")
    with open(flist, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return flist


def _launches() -> dict:
    from ..ops import stft_mel as sm
    from ..ops import teacher_fwd as tf

    return {"K2": sm.mel_spectrogram_fused.launches, "K3": tf.teacher_fwd.launches,
            "K4": tf.teacher_bwd.launches}


def run_corpus(args, hp) -> dict:
    import torch.distributed as dist

    from ..training.train import train

    flist = os.path.join(args.workdir, "train.txt")
    hp = hp.replace(training_files=flist, validation_files=flist)
    _, it = train(os.path.join(args.workdir, "out"), "", None, False, hp,
                  device=args.device, backend=args.backend)
    rank, world = ((dist.get_rank(), dist.get_world_size()) if dist.is_initialized()
                   else (0, 1))
    return {"rank": rank, "world": world, "iters": it, "launches": _launches()}


def _bytes(model, optimizer) -> int:
    """This rank's bytes of parameters and Adam moments."""
    moments = sum(t.numel() * t.element_size() for st in optimizer.state.values()
                  for k, t in st.items() if k in ("exp_avg", "exp_avg_sq"))
    return moments + sum(p.numel() * p.element_size() for p in model.parameters())


def _rows(path, grid, dev) -> dict:
    """This rank's data index's rows of the global batch in ``path``."""
    with np.load(path) as f:
        full = {k: f[k] for k in f.files}
    data, index = (grid.data, grid.data_index) if grid else (1, 0)
    B = next(iter(full.values())).shape[0]
    if B % data:
        raise ValueError(f"batch of {B} rows does not split over {data} data ranks")
    rows = slice(index * (B // data), (index + 1) * (B // data))
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows])).to(
        dev, torch.long if v.dtype.kind in "iu" else torch.float32) for k, v in full.items()}


def _logical_grads(model, grid) -> dict:
    from ..parallel import mesh

    shards = getattr(model, "tp_shards", {})
    return {n: (mesh.gather_shard(p.grad, shards[n], grid) if n in shards
                else p.grad.detach()).cpu().clone() for n, p in model.named_parameters()}


def run_batch(args, hp) -> dict:
    """``--steps`` train steps on this rank's rows of the batch in
    ``--batch``; rank 0 saves losses, norms and the logical state dicts."""
    from ..parallel import mesh
    from ..training.train_state import create_train_state, make_train_step, resolve_device

    grid, dev = mesh.init_distributed(hp, args.device, args.backend)
    if grid is None:
        dev = resolve_device(args.device)
    batch = _rows(args.batch, grid, dev)
    ts = create_train_state(hp, dev, grid=grid)
    if args.init:
        ts.model.load_state_dict(mesh.local_state_dict(
            torch.load(args.init, map_location=dev, weights_only=True), ts.model, grid))
    step = make_train_step(hp, grid)
    gen = torch.Generator(device=dev).manual_seed(hp.seed)
    grads = []  # each step's clipped-before gradient, as the optimizer receives it
    ts.optimizer.register_step_pre_hook(
        lambda opt, a, k: grads.append(_logical_grads(ts.model, grid)))
    init = {k: v.detach().cpu().clone()
            for k, v in mesh.logical_state_dict(ts.model, grid).items()}
    before = _launches()
    t0 = time.perf_counter()
    metrics = [step(ts, batch, gen) for _ in range(args.steps)]
    return _finish(args, grid, ts.model, ts.optimizer, metrics, grads, init, before,
                   batch["text"].shape[0], t0)


def run_waveglow(args) -> dict:
    """``--steps`` WaveGlow train steps on this rank's rows of the
    ``audio``/``mel`` batch in ``--batch``, from ``--init`` (a logical
    state dict) or random weights from the seed."""
    from ..models.waveglow import (WaveGlow, WaveGlowConfig, init_weights,
                                   make_waveglow_train_step)
    from ..parallel import mesh
    from ..training.train_state import resolve_device

    grid, dev = mesh.init_distributed(None, args.device, args.backend, model=args.mesh_model)
    if grid is None:
        dev = resolve_device(args.device)
    cfg = WaveGlowConfig(**json.loads(args.wg_config or "{}"))
    model = WaveGlow(cfg)
    if args.init:
        model.load_state_dict(torch.load(args.init, weights_only=True))
    else:
        init_weights(model, torch.Generator().manual_seed(1234), end_scale=0.05)
    if grid is not None and grid.model > 1:
        mesh.shard_module(model, lambda n: mesh.waveglow_spec(n, cfg.n_layers), grid)
    model = model.to(dev).train()
    opt = torch.optim.Adam(model.parameters(), lr=1e-4, fused=True)
    step = make_waveglow_train_step(model, opt, clip=args.clip, grid=grid)
    batch = _rows(args.batch, grid, dev)
    grads = []
    opt.register_step_pre_hook(lambda o, a, k: grads.append(_logical_grads(model, grid)))
    init = {k: v.detach().cpu().clone()
            for k, v in mesh.logical_state_dict(model, grid).items()}
    t0 = time.perf_counter()
    metrics = [step(batch["audio"], batch["mel"]) for _ in range(args.steps)]
    return _finish(args, grid, model, opt, metrics, grads, init, None,
                   batch["audio"].shape[0], t0)


def _finish(args, grid, model, optimizer, metrics, grads, init, before, rows, t0) -> dict:
    """Rank 0 saves; every rank returns its DRYRUN object (``s_per_step``:
    the steps' wall time to their last loss on the host, first step
    included)."""
    from ..parallel import mesh

    loss = [float(m["loss"]) for m in metrics]
    seconds = time.perf_counter() - t0
    state = {k: v.detach().cpu() for k, v in mesh.logical_state_dict(model, grid).items()}
    rank = grid.rank if grid else 0
    shards = getattr(model, "tp_shards", {})
    out = {"rank": rank, "world": grid.world if grid else 1,
           "model": grid.model if grid else 1, "rows": rows, "loss": loss,
           "s_per_step": seconds / len(metrics),
           "grad_norm": [float(m["grad_norm"]) for m in metrics],
           "updated": [bool(m["updated"]) for m in metrics],
           "bytes": _bytes(model, optimizer),
           "split_bytes": sum(p.numel() * p.element_size() * 3
                              for n, p in model.named_parameters() if n in shards)}
    if "loss_scale" in metrics[0]:
        out["loss_scale"] = [float(m["loss_scale"]) for m in metrics]
    if before is not None:
        out["launches"] = {k: v - before[k] for k, v in _launches().items()}
    if rank == 0 and args.out:
        torch.save({"metrics": out, "grads": grads, "init_state_dict": init,
                    "state_dict": state}, args.out)
    mesh.barrier(grid)
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default=None, help="the corpus directory")
    p.add_argument("--make-corpus", action="store_true", help="write the corpus and exit")
    p.add_argument("--batch", default=None, help="an .npz global batch (the batch mode)")
    p.add_argument("--init", default=None, help="a state dict to start from (batch mode)")
    p.add_argument("--out", default=None, help="where rank 0 saves its result (batch mode)")
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--hparams", default=None, help="overrides after the tiny widths")
    p.add_argument("--full-width", action="store_true", help="the hparams defaults, not tiny")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    p.add_argument("--backend", default=None, help="process-group backend (default: "
                   "nccl on a card, gloo on the CPU)")
    p.add_argument("--waveglow", action="store_true", help="WaveGlow steps (batch mode)")
    p.add_argument("--wg-config", default=None, help="WaveGlowConfig fields as JSON")
    p.add_argument("--mesh-model", type=int, default=1, help="WaveGlow: model ranks a row")
    p.add_argument("--clip", type=float, default=None,
                   help="WaveGlow: clip the gradients to this global norm")
    args = p.parse_args(argv)
    if args.make_corpus:
        make_corpus(args.workdir)
        print("corpus ready", flush=True)
        return
    from ..config import create_hparams
    from ..parallel import mesh

    spec = ",".join(s for s in ("" if args.full_width else TINY,
                                "" if args.batch else CORPUS, args.hparams or "") if s)
    hp = create_hparams(spec or None)
    try:
        out = (run_waveglow(args) if args.waveglow else
               run_batch(args, hp) if args.batch else run_corpus(args, hp))
        # one write, so that ranks sharing a pipe do not interleave a line
        sys.stdout.write("DRYRUN " + json.dumps(out) + "\n")
        sys.stdout.flush()
    finally:
        mesh.shutdown()


if __name__ == "__main__":
    main()
