"""Serving runtime: batched greedy / temperature decoding over the KV cache.

Counterpart of ``repro.runtime.serve``.  ``generate`` runs one prefill
over the (left-padded) prompt batch, then one decode step per new token.
A model with a ``prefill`` method (``DecoderLM``) prefills in one pass; the
others (the hybrid, xLSTM and encoder-decoder models) are fed the prompt
through ``decode_step`` one token at a time (teacher forcing), as the
reference's ``_default_prefill`` does.  Per-row left-padding offsets go
only to a model with ``supports_position_offsets``; the others run a
padded row's pad tokens as the reference does.
PyTorch runs eagerly, so there is nothing to compile or memoize
(``repro_torch.serve.Server`` captures each bucket's steps as CUDA graphs
instead).  Each decode step takes its cache slot as a 0-d tensor on the
device, checked on the host first, as the captured steps do.  With a
``mesh`` of more than one rank, the whole decode runs inside
``planned_scope``: every projection goes through the plan engine
(``tuning=`` prices and tiles its plans with measured kernel seconds).
Under ``repro_torch.obs`` tracing the prefill and each decode step are
``serve.prefill`` / ``serve.decode_step`` spans (tagged with the batch's
``rows``), and each sampling is a ``serve.sample`` span.
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
    if lens is not None and takes_offsets(model):
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


def takes_offsets(model) -> bool:
    """Whether ``model`` masks left-padding by per-row position offsets."""
    return getattr(model, "supports_position_offsets", False)


def prefill(model, params, cache, tokens: torch.Tensor,
            offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The prompt's last-token logits (B, V_padded), the cache filled.

    ``model.prefill`` in one pass where the model has one; otherwise
    ``decode_step`` on each prompt token in turn at slots 0..S-1 (teacher
    forcing, no offsets), step t's slot a 0-d view of one ``arange`` on the
    device, so no step waits for the host and the loop can be captured
    whole.  The last slot is checked on the host first."""
    if hasattr(model, "prefill"):
        return model.prefill(params, cache, tokens, offsets)[0]
    s = tokens.shape[1]
    model.check_decode_pos(cache, s - 1)
    slots = torch.arange(s, dtype=torch.int64, device=tokens.device)
    logits = None
    for t in range(s):
        logits = model.decode_step(params, cache, tokens[:, t:t + 1], slots[t])[0]
    return logits


def decode_step(model, params, cache, cur: torch.Tensor, pos,
                offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode step's logits (B, V_padded): ``offsets`` go only to a
    model that takes them."""
    if offsets is not None and takes_offsets(model):
        return model.decode_step(params, cache, cur, pos, offsets)[0]
    return model.decode_step(params, cache, cur, pos)[0]


def decode_loop(model, params, cache, tokens: torch.Tensor,
                offsets: Optional[torch.Tensor], cfg: ServeConfig,
                generator: Optional[torch.Generator], on_token=None
                ) -> Tuple[np.ndarray, list]:
    """Prefill + ``max_new_tokens - 1`` decode steps on a prepared cache,
    eagerly (``token_loop`` with ``prefill`` and ``decode_step``)."""
    return token_loop(
        model, cache, tokens, cfg, generator,
        prefill=lambda: prefill(model, params, cache, tokens, offsets),
        step=lambda cur, pos: decode_step(model, params, cache, cur, pos, offsets),
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
    with obs.span("serve.prefill", rows=b, seq=sp):
        logits = prefill()
    if cfg.max_new_tokens > 0:
        with obs.span("serve.sample"):
            cur = _sample(logits, cfg, generator)
        out.append(cur[:, None])
        if on_token is not None:
            marks.append(on_token())
        for t in range(sp, sp + cfg.max_new_tokens - 1):
            model.check_decode_pos(cache, t)
            with obs.span("serve.decode_step", rows=b, pos=t):
                pos = torch.full((), t, dtype=torch.int64, device=tokens.device)
                logits = step(cur[:, None], pos)
                with obs.span("serve.sample"):
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
