"""Port: repairs of faults the port had against the reference.

* Superseded mel caches are evicted as the JAX loader evicts them: three
  revisions of one wav, featurised by ``get_mel`` or by
  ``warm_mel_cache``, leave the same files in the port's corpus as in the
  JAX package's (the two corpora are written with equal names, bytes and
  mtimes, so their cache names are equal too); a wav whose name holds glob
  metacharacters (``foo[ab].wav``) leaves its sibling ``fooa.wav``'s cache.
* cuDNN's flags: the three contexts that turn TF32 off keep the process's
  ``enabled`` and ``benchmark``, and the entry points set both from the
  hparams.
* The HTTP CLI accepts the reference's ``--debug`` and ``--is_korean``.
* ``train_waveglow --export`` with neither a resume nor a step to train is
  refused and writes nothing.
"""

import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from _torch_port_common import TINY
from _torch_port_common import one_thread  # noqa: F401 (autouse)
from tacotron2_vae_tpu.config import create_hparams as jax_hparams
from tacotron2_vae_tpu.data import dataset as jds
from tacotron2_vae_torch.config import create_hparams
from tacotron2_vae_torch.data import dataset as ds

MTIME_NS = 1_700_000_000_000_000_000


def _write(path, seconds, freq, revision):
    """A 16 kHz wav whose bytes and mtime depend on ``revision``."""
    n = int(16000 * seconds) + 160 * revision
    x = 0.3 * np.sin(2 * np.pi * (freq + 10 * revision) * np.arange(n) / 16000)
    wavfile.write(path, 16000, (x * 32767).astype(np.int16))
    os.utime(path, ns=(MTIME_NS + revision, MTIME_NS + revision))


def _corpus(root):
    os.makedirs(root)
    flist = os.path.join(root, "train.txt")
    with open(flist, "w", encoding="utf-8") as f:
        for name in ("foo[ab].wav", "fooa.wav"):
            f.write(f"{os.path.join(root, name)}|안녕|0|0\n")
    return flist


def _featurise(dataset, path, how):
    if how == "get_mel":
        dataset.get_mel(path)
    else:
        dataset.warm_mel_cache()


@pytest.mark.parametrize("how", ["get_mel", "warm_mel_cache"])
def test_superseded_mel_caches_are_evicted_as_jax_evicts_them(tmp_path, how):
    roots = {"port": str(tmp_path / "port"), "jax": str(tmp_path / "jax")}
    sets = {
        "port": ds.TextMelDataset(_corpus(roots["port"]), create_hparams(), shuffle=False,
                                  device="cpu"),
        "jax": jds.TextMelDataset(_corpus(roots["jax"]), jax_hparams(), shuffle=False),
    }
    for side, root in roots.items():
        _write(os.path.join(root, "fooa.wav"), 0.4, 200, 0)
        sets[side].get_mel(os.path.join(root, "fooa.wav"))
    for revision in range(3):
        for side, root in roots.items():
            path = os.path.join(root, "foo[ab].wav")
            _write(path, 0.5, 300, revision)
            _featurise(sets[side], path, how)
    listed = {side: sorted(os.listdir(root)) for side, root in roots.items()}
    assert listed["port"] == listed["jax"]
    caches = [n for n in listed["port"] if n.endswith(".npy")]
    assert len(caches) == 2, caches
    for name in ("foo[ab].wav", "fooa.wav"):
        cache = sets["port"].mel_cache_path(os.path.join(roots["port"], name))
        assert os.path.basename(cache) in caches


def test_eviction_leaves_other_writers_temporary_files(tmp_path):
    flist = _corpus(str(tmp_path / "c"))
    dataset = ds.TextMelDataset(flist, create_hparams(), shuffle=False, device="cpu")
    path = str(tmp_path / "c" / "fooa.wav")
    _write(path, 0.4, 200, 0)
    first = dataset.mel_cache_path(path)
    dataset.get_mel(path)
    other = first[:-len(".npy")] + ".77.tmp.npy"  # a concurrent writer's file
    open(other, "wb").close()
    _write(path, 0.4, 200, 1)
    dataset.get_mel(path)
    assert not os.path.exists(first)
    assert os.path.exists(other) and os.path.exists(dataset.mel_cache_path(path))


# ----------------------------------------------------------------- cuDNN flags


@pytest.fixture
def cudnn_flags():
    c = torch.backends.cudnn
    saved = (c.enabled, c.benchmark, c.allow_tf32)
    yield c
    c.enabled, c.benchmark, c.allow_tf32 = saved


def _spy(monkeypatch, name, seen):
    inner = getattr(torch.nn.functional, name)

    def spy(*args, **kwargs):
        c = torch.backends.cudnn
        seen.append((c.enabled, c.benchmark, c.allow_tf32))
        return inner(*args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, name, spy)


def _run_layers_conv2d():
    from tacotron2_vae_torch.ops import layers

    layers.conv2d(torch.randn(1, 6, 5, 2), torch.randn(4, 2, 3, 3))


def _run_loc_conv():
    from tacotron2_vae_torch.ops import teacher_fwd

    teacher_fwd.loc_conv(torch.rand(2, 7), torch.rand(2, 7), torch.randn(5, 2, 3))


def _run_waveglow():
    from tacotron2_vae_torch.models.waveglow import WaveGlow, WaveGlowConfig, init_weights

    cfg = WaveGlowConfig(n_flows=2, n_group=8, n_early_every=2, n_early_size=2, n_layers=1,
                         n_channels=4)
    wg = init_weights(WaveGlow(cfg), torch.Generator().manual_seed(0))
    mel = torch.randn(1, 80, 3)
    with torch.no_grad():
        wg(torch.randn(1, 256), mel)
        wg.infer(mel, 0.5, torch.Generator().manual_seed(1))


@pytest.mark.parametrize("benchmark", [True, False])
@pytest.mark.parametrize("where,run,conv", [
    ("ops.layers.conv2d", _run_layers_conv2d, ("conv2d",)),
    ("ops.teacher_fwd.loc_conv", _run_loc_conv, ("conv1d",)),
    ("models.waveglow", _run_waveglow, ("conv1d", "conv_transpose1d")),
])
def test_tf32_contexts_keep_the_process_cudnn_settings(monkeypatch, cudnn_flags, where, run,
                                                       conv, benchmark):
    seen = []
    for name in conv:
        _spy(monkeypatch, name, seen)
    cudnn_flags.enabled, cudnn_flags.benchmark, cudnn_flags.allow_tf32 = True, benchmark, True
    run()
    assert seen, where
    assert set(seen) == {(True, benchmark, False)}, (where, set(seen))
    assert (cudnn_flags.benchmark, cudnn_flags.allow_tf32) == (benchmark, True)


class _Stop(Exception):
    pass


def _stop(*args, **kwargs):
    raise _Stop


def _enter_train(monkeypatch, hparams, tmp):
    from tacotron2_vae_torch.training import train as tr

    monkeypatch.setattr(tr, "create_train_state", _stop)
    tr.train(str(tmp / "out"), "logs", None, False, create_hparams(hparams), device="cpu")


def _enter_synthesizer(monkeypatch, hparams, tmp):
    from tacotron2_vae_torch.serving.synthesizer import Synthesizer

    Synthesizer(create_hparams(hparams), device="cpu")
    raise _Stop


def _enter_train_waveglow(monkeypatch, hparams, tmp):
    from tacotron2_vae_torch.tools import train_waveglow as tw

    # the tool has no --hparams: it takes the defaults' flags
    monkeypatch.setattr(tw, "create_hparams", lambda: create_hparams(hparams))
    monkeypatch.setattr(tw, "init_weights", _stop)
    tw.train_waveglow(tw.parse_args(["--filelist", "none.txt", "--output_dir",
                                     str(tmp / "wg"), "--device", "cpu"]))


@pytest.mark.parametrize("enabled,benchmark", [(True, True), (False, False), (True, False)])
@pytest.mark.parametrize("enter", [_enter_train, _enter_synthesizer, _enter_train_waveglow],
                         ids=["train", "Synthesizer", "train_waveglow"])
def test_entry_points_set_cudnn_flags_from_hparams(monkeypatch, cudnn_flags, tmp_path, enter,
                                                   enabled, benchmark):
    cudnn_flags.enabled, cudnn_flags.benchmark = not enabled, not benchmark
    with pytest.raises(_Stop):
        enter(monkeypatch, f"{TINY},cudnn_enabled={enabled},cudnn_benchmark={benchmark}",
              tmp_path)
    assert (cudnn_flags.enabled, cudnn_flags.benchmark) == (enabled, benchmark)


# ----------------------------------------------------------------- CLIs


def test_http_cli_accepts_the_reference_flags():
    from tacotron2_vae_torch.serving import app

    args = app.parse_args(["--checkpoint_path", "c.pt", "--is_korean", "True",
                           "--debug", "False", "--port", "5"])
    assert (args.checkpoint_path, args.port, args.is_korean, args.debug) == \
        ("c.pt", 5, "True", "False")
    args = app.parse_args(["--checkpoint_path", "c.pt"])
    assert (args.is_korean, args.debug, args.max_batch) == (True, False, 4)


def test_waveglow_export_of_untrained_weights_is_refused(tmp_path):
    from tacotron2_vae_torch.tools import train_waveglow as tw

    out, pkl = tmp_path / "wg", tmp_path / "untrained.pkl"
    with pytest.raises(SystemExit) as exc:
        tw.main(["--filelist", "none.txt", "--output_dir", str(out), "--steps", "0",
                 "--export", str(pkl), "--device", "cpu"])
    assert exc.value.code not in (0, None) and "--resume" in str(exc.value.code)
    assert not pkl.exists() and not out.exists()
