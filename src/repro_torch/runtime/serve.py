"""Serving runtime: batched greedy / temperature decoding over the KV cache.

Counterpart of ``repro.runtime.serve`` on one device.  ``generate`` runs one
prefill over the (left-padded) prompt batch, then one decode step per new
token.  PyTorch runs eagerly, so there is nothing to compile or memoize;
the plan-engine scope (``mesh=``) waits for the plan slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import param_device


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0     # 0 => greedy
    max_seq: int = 256

    def __post_init__(self):
        if self.max_new_tokens < 0:
            raise ValueError(
                f"max_new_tokens must be >= 0, got {self.max_new_tokens}")
        if self.max_seq <= 0:
            raise ValueError(f"max_seq must be > 0, got {self.max_seq}")
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")

    def validate_prompt_len(self, sp: int) -> None:
        """The cache holds ``max_seq`` slots; a prompt of ``sp`` tokens plus
        ``max_new_tokens`` generated ones must fit."""
        if sp + self.max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt length {sp} + max_new_tokens {self.max_new_tokens} "
                f"exceeds max_seq {self.max_seq}; raise max_seq or shorten "
                f"the request")


def generate(
    model, params, prompts: np.ndarray, cfg: ServeConfig,
    generator: Optional[torch.Generator] = None,
    *,
    lens: Optional[np.ndarray] = None,
) -> np.ndarray:
    """prompts: (B, S_prompt) int -> (B, S_prompt + max_new_tokens) numpy.

    ``lens`` gives the true lengths of a left-padded batch: each row then
    decodes at its own logical positions.  ``generator`` drives temperature
    sampling (on the model's device)."""
    b, sp = prompts.shape
    if b == 0:
        return np.asarray(prompts)
    cfg.validate_prompt_len(sp)
    device = param_device(params)
    cache = model.init_cache(b, cfg.max_seq, device)
    offsets = None
    if lens is not None:
        offsets = torch.as_tensor(sp - np.asarray(lens), dtype=torch.int64, device=device)
    tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int64, device=device)
    with torch.no_grad():
        return decode_loop(model, params, cache, tokens, offsets, cfg, generator)[0]


def decode_loop(model, params, cache, tokens: torch.Tensor,
                offsets: Optional[torch.Tensor], cfg: ServeConfig,
                generator: Optional[torch.Generator], on_token=None
                ) -> Tuple[np.ndarray, list]:
    """Prefill + ``max_new_tokens - 1`` decode steps on a prepared cache.
    Returns the full (B, S + new) token array and the results of
    ``on_token()``, called after each token is sampled (the server's
    latency clock)."""
    sp = tokens.shape[1]
    out = [tokens]
    marks = []
    logits, cache = model.prefill(params, cache, tokens, offsets)
    if cfg.max_new_tokens > 0:
        cur = _sample(logits, cfg, generator)
        out.append(cur[:, None])
        if on_token is not None:
            marks.append(on_token())
        for t in range(sp, sp + cfg.max_new_tokens - 1):
            logits, cache = model.decode_step(params, cache, cur[:, None], t, offsets)
            cur = _sample(logits, cfg, generator)
            out.append(cur[:, None])
            if on_token is not None:
                marks.append(on_token())
    return torch.cat(out, dim=1).cpu().numpy(), marks


def _sample(logits: torch.Tensor, cfg: ServeConfig,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits / cfg.temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def batch_requests(
    prompt_list: Sequence[Sequence[int]], pad_id: int = 0,
    *, pad_to: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Left-pad variable-length prompts into one (B, S) batch; returns
    ``(batch, lens)``.  An empty list gives an explicit (0, 0) batch;
    ``pad_to`` pads the sequence axis to a fixed width (a bucket's seq)."""
    if not prompt_list:
        return (np.zeros((0, pad_to or 0), np.int32),
                np.zeros((0,), np.int32))
    maxlen = max(len(p) for p in prompt_list)
    if pad_to is not None:
        if pad_to < maxlen:
            raise ValueError(
                f"pad_to={pad_to} shorter than longest prompt ({maxlen})")
        maxlen = pad_to
    batch = np.full((len(prompt_list), maxlen), pad_id, np.int32)
    lens = np.zeros(len(prompt_list), np.int32)
    for i, pr in enumerate(prompt_list):
        if len(pr) == 0:
            raise ValueError(f"request {i} is empty; prompts need >= 1 token")
        batch[i, maxlen - len(pr):] = pr
        lens[i] = len(pr)
    return batch, lens
