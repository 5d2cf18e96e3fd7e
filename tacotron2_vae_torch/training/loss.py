"""Tacotron2-VAE loss with KL annealing (JAX ``training/loss.py``).

Reference ``Tacotron2Loss_VAE`` (loss_function.py:6-45): MSE(mel) +
MSE(mel_postnet) + BCE-with-logits(gate) + kl_weight * KL, with the KL
summed (not meaned) over batch and latent dims, and three anneal schedules.
"""

from __future__ import annotations

import torch


def kl_anneal_weight(anneal_function: str, lag, step, k, x0, upper) -> torch.Tensor:
    """KL weight schedule (loss_function.py:15-24), in float32."""
    step = torch.tensor(float(step), dtype=torch.float32)
    if anneal_function == "logistic":
        return upper / (upper + torch.exp(-k * (step - x0)))
    if anneal_function == "linear":
        return torch.where(step > lag, torch.clamp(step / x0, max=upper), 0.0)
    if anneal_function == "constant":
        return torch.tensor(0.001, dtype=torch.float32)
    raise ValueError(f"unknown anneal_function {anneal_function!r}")


def bce_with_logits(logits, targets):
    """Numerically stable sigmoid cross-entropy, meaned."""
    return torch.mean(torch.clamp(logits, min=0.0) - logits * targets
                      + torch.log1p(torch.exp(-logits.abs())))


def tacotron2_vae_loss(outputs, mel_target, gate_target, step, hp):
    """(total, aux) with aux = recon_loss, mel_loss, gate_loss, kl_loss,
    kl_weight.  With r > 1 frames per step each step's gate logit is held
    against the target at its group's last frame."""
    mel_loss = (torch.mean((outputs.mel_outputs - mel_target) ** 2)
                + torch.mean((outputs.mel_outputs_postnet - mel_target) ** 2))
    gate_out = outputs.gate_outputs
    if gate_target.shape[1] != gate_out.shape[1]:
        r = gate_target.shape[1] // gate_out.shape[1]
        gate_target = gate_target[:, r - 1::r]
    gate_loss = bce_with_logits(gate_out.reshape(-1), gate_target.reshape(-1))
    kl_loss = -0.5 * torch.sum(1.0 + outputs.logvar - outputs.mu ** 2 - torch.exp(outputs.logvar))
    kl_weight = kl_anneal_weight(hp.anneal_function, hp.anneal_lag, step, hp.anneal_k,
                                 hp.anneal_x0, hp.anneal_upper).to(mel_loss.device)
    recon_loss = mel_loss + gate_loss
    aux = {"recon_loss": recon_loss, "mel_loss": mel_loss, "gate_loss": gate_loss,
           "kl_loss": kl_loss, "kl_weight": kl_weight}
    return recon_loss + kl_weight * kl_loss, aux
