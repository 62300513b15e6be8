"""``serve.py``'s closed loop of request batches for a latent-attention
(MLA) configuration: the same driver, with the weights made by
``latent_weights`` (MLA's attention leaves) in place of ``weights``.
``setup`` is ``serve.Driver.setup`` with that one call changed; the
window, the traced stretch, the eager step, the check and ``reseed``
(``weights.refill`` draws into either tree) are ``serve.py``'s."""
from __future__ import annotations

import time
from typing import List

from portbench import latent_weights, spec
from portbench.drivers import serve


class Driver(serve.Driver):
    def setup(self) -> None:
        from repro_torch.models.config import ModelConfig
        from repro_torch.models.lm import DecoderLM
        from repro_torch.runtime.serve import ServeConfig
        from repro_torch.serve import Server

        ctx, wl, tr = self.ctx, self.ctx.workload, self.ctx.traffic
        self.bucket = tuple(wl["bucket"])
        self.max_seq = int(wl["max_seq"])
        self.new_tokens = int(tr["max_new_tokens"])
        t0 = time.perf_counter()
        self.params = latent_weights.make(ctx.model, ctx.seed, ctx.device)
        self.tree = latent_weights.program_tree(self.params)
        t1 = time.perf_counter()
        self.model = DecoderLM(ModelConfig(**ctx.model))
        self.server = Server(self.model, self.tree,
                             ServeConfig(max_new_tokens=self.new_tokens, temperature=0.0,
                                         max_seq=self.max_seq),
                             buckets=[self.bucket])
        report = self.server.warmup([self.bucket])[f"{self.bucket[0]}x{self.bucket[1]}"]
        self.phases = {"weights_s": t1 - t0, "warm_s": report["warm_s"],
                       "capture_s": report.get("capture_s", 0.0)}
        self.gen = spec.traffic_kind(tr["kind"])
        self.batches = self.gen.Batches(tr, ctx.seed, self._vocab())
        self.served: List = []
