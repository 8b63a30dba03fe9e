"""Deterministic, resumable data pipeline (counterpart of
``repro/data/pipeline.py``).

State is (seed, step), nothing else: ``batch(step)`` is a pure function, so
a restart resumes bit-exactly from any step. ``poisson_q > 0`` is the
fixed-capacity Poisson subsampling the RDP accountant assumes: each step
draws an inclusion mask ~ Bernoulli(q) over the physical batch and hands it
to the loss as a 0/1 ``mask`` over the tokens (the decoder's, in the
encdec family; the text's, not the patches', in the vlm family). Tokens,
patches and mask equal the reference's bitwise: the mask's uniforms are
``data.synthetic.uniform`` under
``fold_in(fold_in(prng_key(seed), step), 0xD1CE)``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.noise import fold_in, prng_key
from repro_torch.data.synthetic import make_batch, uniform

POISSON_SALT = 0xD1CE


@dataclass(frozen=True)
class PipelineConfig:
    batch: int
    seq_len: int
    seed: int = 0
    poisson_q: float = 0.0   # 0 = fixed-size sampling


class Pipeline:
    def __init__(self, model_cfg: ModelConfig, cfg: PipelineConfig,
                 device="cuda"):
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.device = torch.device(device)

    def spec(self) -> dict:
        """The batch's shapes and dtypes, as meta tensors (encdec: seq_len
        counts the encoder's audio frames; the decoder's tokens are
        ``decoder_len`` long; vlm: ``patch_tokens`` patches beside the
        tokens)."""
        B, T, mc = self.cfg.batch, self.cfg.seq_len, self.model_cfg
        if mc.family == "encdec":
            return {"frames": torch.empty(
                        (B, T, mc.frame_dim or mc.d_model),
                        dtype=torch.float32, device="meta"),
                    "tokens": torch.empty((B, mc.decoder_len),
                                          dtype=torch.int32, device="meta")}
        spec = {"tokens": torch.empty((B, T), dtype=torch.int32,
                                      device="meta")}
        if mc.family == "vlm":
            spec["patches"] = torch.empty((B, mc.patch_tokens, mc.vit_dim),
                                          dtype=torch.float32, device="meta")
        return spec

    def state_dict(self) -> dict:
        """The generative config a resumed run must continue (the cursor
        is the train step the caller persists)."""
        return {"seed": self.cfg.seed, "batch": self.cfg.batch,
                "seq_len": self.cfg.seq_len,
                "poisson_q": self.cfg.poisson_q}

    def load_state(self, state: dict) -> None:
        """Raise unless this pipeline continues the checkpointed stream (a
        changed seed or batch size re-samples the data, voiding bitwise
        resume and the accounted sample rate)."""
        mine = self.state_dict()
        drift = {k: (state.get(k), mine[k]) for k in mine
                 if state.get(k) != mine[k]}
        if drift:
            raise ValueError(
                "data-pipeline state drift between checkpoint and resumed "
                "run (checkpointed != configured): "
                + ", ".join(f"{k}: {a!r} != {b!r}"
                            for k, (a, b) in sorted(drift.items())))

    def batch(self, step: int) -> dict:
        b = make_batch(self.model_cfg, self.cfg.batch, self.cfg.seq_len,
                       seed=self.cfg.seed, step=step, device=self.device)
        if self.cfg.poisson_q > 0.0:
            key = fold_in(fold_in(prng_key(self.cfg.seed), step),
                          POISSON_SALT)
            tokens = b["tokens"]
            q = torch.tensor(self.cfg.poisson_q, dtype=torch.float32,
                             device=self.device)
            include = uniform(key, (tokens.shape[0],), self.device) < q
            b = dict(b, mask=include[:, None].expand(tokens.shape).to(
                torch.float32))
        return b

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
