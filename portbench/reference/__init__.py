"""The benchmark's plain reference of Tacotron2-VAE and WaveGlow.

Plain PyTorch and NumPy in float32 with TF32 off, written from the
published models (Tacotron2 with location-sensitive attention, the VAE
reference encoder of Tacotron2-VAE, NVIDIA's WaveGlow) and the layouts
of the state dicts the benchmark makes.  It imports neither JAX nor
anything of the program under test: ``text/`` and ``mel.py`` are frozen
copies of the port's text front end and mel filterbank, ``hashdrop`` a
frozen copy of the decode kernel's dropout hash, ``loader`` of the
training loader's batch order.  The benchmark hands it the same weights,
wavs, texts and seeds it hands the program, and it works out again what
the program derived from them.

``quant`` selects the precision of every matrix and convolution operand:
None is float32, ``fp8`` rounds each operand to float8 e4m3 with a
per-tensor scale (the control, one step below the bfloat16 the
configuration states).
"""

import torch


def setup():
    """Full float32 products (TF32 off) and no cuDNN autotuning (each of
    the reference's shapes runs once) in this process, for the reference,
    which runs after the program's window."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
