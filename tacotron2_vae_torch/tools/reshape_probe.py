"""Reshape and output-block probes on the card (kernels K5 and K6).

Counterpart of ``tools/reshape_probe.py``, whose two Pallas kernels asked
which value reshapes and output blocks Mosaic compiles.  The same probes
here build the same inputs, run them through the hand-written kernels of
``ops/reshape_probe.py`` and check the result against the JAX probes' own
expectation: ``x.reshape(B*S, X) + 1``, and 128.0 everywhere.  Each prints
the JAX probe's line and returns whether the probe passed.

    python -m tacotron2_vae_torch.tools.reshape_probe [--device cpu]

Runs on the card unless ``device="cpu"`` is given, and raises without one.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..ops.reshape_probe import out_block_matmul, reshape_rows_plus_one


def _device(device=None) -> torch.device:
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the probes run on a CUDA card and none is available; "
                           "pass device='cpu' to run their plain twins")
    return dev


def probe_reshape(S, X, B=4, device=None) -> bool:
    """x (B, S*X) -> per-b rows (S, X) stored into a (B*S, X) output (K5)."""
    x = torch.arange(B * S * X, dtype=torch.float32, device=_device(device)).reshape(B, S * X)
    try:
        out = reshape_rows_plus_one(x, S, X)
        ok = bool(torch.allclose(out, x.reshape(B * S, X) + 1.0))
        print(f"reshape (1,{S * X})->({S},{X}): compiles, correct={ok}")
        return ok
    except Exception as e:  # noqa: BLE001 - a probe reports what fails
        print(f"reshape (1,{S * X})->({S},{X}): FAIL {type(e).__name__}: {str(e)[:160]}")
        return False


def probe_out_block(BS=512, F=32, T=4, device=None) -> bool:
    """Per-step (1, BS, F) output blocks written from a product (K6)."""
    dev = _device(device)
    x = torch.ones((BS, 128), dtype=torch.float32, device=dev)
    w = torch.ones((128, F), dtype=torch.float32, device=dev)
    try:
        out = out_block_matmul(x, w, T)
        ok = bool(torch.allclose(out, torch.full_like(out, 128.0)))
        print(f"out block (1,{BS},{F}): compiles, correct={ok}")
        return ok
    except Exception as e:  # noqa: BLE001 - a probe reports what fails
        print(f"out block (1,{BS},{F}): FAIL {type(e).__name__}: {str(e)[:160]}")
        return False


def main(argv=None) -> bool:
    """The four probes of the JAX tool; True when all pass."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    device = _device(parser.parse_args(argv).device)
    print("device:", torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    results = [probe_reshape(128, 128, device=device),   # the proven-legal control
               probe_reshape(128, 32, device=device),    # the F-width suspect
               probe_reshape(128, 256, device=device),   # wider than a lane row
               probe_out_block(device=device)]
    return all(results)


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
