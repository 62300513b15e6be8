"""The numbers that decide ``correct``, each computed from the program's
output and the plain reference's (``decoder.py``)."""
from __future__ import annotations

import torch


def worst_row_rel_err(out: torch.Tensor, ref: torch.Tensor, block: int = 2048) -> float:
    """The largest ||out - ref|| / ||ref|| over the rows (last dim) of two
    logit tensors, both read in fp32 a block of rows at a time."""
    o, r = out.reshape(-1, out.shape[-1]), ref.reshape(-1, ref.shape[-1])
    worst = torch.zeros((), device=r.device)
    for i in range(0, o.shape[0], block):
        rf = r[i:i + block].float()
        d = o[i:i + block].to(rf.device).float() - rf
        rel = d.norm(dim=1) / rf.norm(dim=1).clamp_min(1e-30)
        worst = torch.maximum(worst, torch.where(torch.isfinite(rel), rel, torch.inf).max())
    return float(worst)


def gaps(ref_logits: torch.Tensor, tokens: torch.Tensor, vocab: int) -> torch.Tensor:
    """At each position, the gap by which the chosen token's reference
    logit lies below the reference's best, in units of the spread (the
    standard deviation) of the reference's logits there, so that a gap
    reads alike at any width and depth (inf where not finite):
    ``ref_logits`` (..., V_padded), ``tokens`` (...) the tokens chosen
    there, ``vocab`` the real columns."""
    real = ref_logits[..., :vocab]
    best = real.max(dim=-1).values
    chosen = real.gather(-1, tokens[..., None].to(real.device).long())[..., 0]
    gap = (best - chosen) / real.std(dim=-1)
    return torch.where(torch.isfinite(gap), gap, torch.inf).flatten()


def gap_readings(ref_logits: torch.Tensor, tokens: torch.Tensor, vocab: int) -> dict:
    """``logit_gap``, the widest gap (``gaps``) over the positions;
    ``logit_gap_mean``, the mean gap; ``token_mismatch``, the share of
    positions whose token is not the reference's best."""
    g = gaps(ref_logits, tokens, vocab)
    return {"logit_gap": float(g.max()), "logit_gap_mean": float(g.mean()),
            "token_mismatch": float((g > 0).float().mean())}
