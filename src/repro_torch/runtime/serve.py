"""Serving runtime: batched greedy / temperature decoding over the KV cache.

Counterpart of ``repro.runtime.serve``.  ``generate`` runs one prefill
over the (left-padded) prompt batch, then one decode step per new token.
PyTorch runs eagerly, so there is nothing to compile or memoize
(``repro_torch.serve.Server`` captures each bucket's steps as CUDA graphs
instead).  Each decode step takes its cache slot as a 0-d tensor on the
device, checked on the host first, as the captured steps do.  With a
``mesh`` of more than one rank, the whole decode runs inside
``planned_scope``: every projection goes through the plan engine
(``tuning=`` prices and tiles its plans with measured kernel seconds).
Under ``repro_torch.obs`` tracing the prefill and each decode step are
``serve.prefill`` / ``serve.decode_step`` spans.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
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
    mesh=None,
    strategy: Optional[str] = None,
    tuning=None,
) -> np.ndarray:
    """prompts: (B, S_prompt) int -> (B, S_prompt + max_new_tokens) numpy.

    ``lens`` gives the true lengths of a left-padded batch: each row then
    decodes at its own logical positions.  ``generator`` drives temperature
    sampling (on the model's device).  ``mesh`` / ``strategy`` / ``tuning``
    route every projection through the plan engine (``planned_scope``)."""
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
    with torch.no_grad(), planned_scope(mesh, strategy, tuning):
        return decode_loop(model, params, cache, tokens, offsets, cfg, generator)[0]


def planned_scope(mesh, strategy: Optional[str] = None, tuning=None):
    """The plan-routing scope ``generate`` decodes under: route through
    ``planned_matmuls(mesh, strategy, tuning)`` when a multi-rank mesh is
    given, otherwise a null context (the local path)."""
    if mesh is not None and getattr(mesh, "size", 1) > 1:
        from repro_torch.plan import planned_matmuls

        return planned_matmuls(mesh, strategy, tuning)
    return contextlib.nullcontext()


def decode_loop(model, params, cache, tokens: torch.Tensor,
                offsets: Optional[torch.Tensor], cfg: ServeConfig,
                generator: Optional[torch.Generator], on_token=None
                ) -> Tuple[np.ndarray, list]:
    """Prefill + ``max_new_tokens - 1`` decode steps on a prepared cache,
    eagerly (``token_loop`` with the model's own steps)."""
    return token_loop(
        model, cache, tokens, cfg, generator,
        prefill=lambda: model.prefill(params, cache, tokens, offsets)[0],
        step=lambda cur, pos: model.decode_step(params, cache, cur, pos, offsets)[0],
        on_token=on_token)


def token_loop(model, cache, tokens: torch.Tensor, cfg: ServeConfig,
               generator: Optional[torch.Generator], *, prefill, step, on_token=None
               ) -> Tuple[np.ndarray, list]:
    """The decode loop over ``prefill()`` (the prompt's last-token logits)
    and ``step(cur, pos)`` (one decode step's logits for tokens ``cur``
    (B, 1) at cache slot ``pos``, a 0-d tensor on the device, checked on
    the host first).  Returns the full (B, S + new) token array and the
    results of ``on_token()``, called after each token is sampled (the
    server's latency clock)."""
    b, sp = tokens.shape
    out = [tokens]
    marks = []
    with obs.span("serve.prefill", batch=b, seq=sp):
        logits = prefill()
    if cfg.max_new_tokens > 0:
        cur = _sample(logits, cfg, generator)
        out.append(cur[:, None])
        if on_token is not None:
            marks.append(on_token())
        for t in range(sp, sp + cfg.max_new_tokens - 1):
            model.check_decode_pos(cache, t)
            with obs.span("serve.decode_step", batch=b, pos=t):
                pos = torch.full((), t, dtype=torch.int64, device=tokens.device)
                cur = _sample(step(cur[:, None], pos), cfg, generator)
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
