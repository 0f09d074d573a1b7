"""Uniform model API (counterpart of ``repro.models.api``), families
``"lm"`` and ``"vlm"`` (the same decoder; a vlm's prefill batch carries
``patch_embeds``).

``get_api(cfg)`` returns a :class:`ModelAPI` whose members share the
reference's signatures, plus the layer-sliced decode surface
(``slice_params`` / ``slice_cache`` / ``decode_embed`` / ``decode_stage``
/ ``decode_unembed``); ``decode_step`` is their one-stage composition.
Training entries (``train_loss``, axes) wait for ROADMAP step 15.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    family: str
    init_params: Callable      # (cfg, seed, device) -> params
    prefill: Callable          # (cfg, params, batch) -> (logits, cache)
    decode_step: Callable      # pos: () shared or (B,) per-slot positions
    init_cache: Callable       # (cfg, batch, max_len, device) -> cache
    slice_params: Callable
    slice_cache: Callable
    decode_embed: Callable
    decode_stage: Callable
    decode_unembed: Callable
    decode_slice_points: Callable
    supports_bucketed_prefill: bool = False


def _tf_prefill(cfg, params, batch):
    return transformer.prefill(
        cfg, params, batch["tokens"], batch.get("patch_embeds"),
        lengths=batch.get("lengths"),
    )


_TRANSFORMER_API = ModelAPI(
    family="lm",
    init_params=transformer.init_params,
    prefill=_tf_prefill,
    decode_step=transformer.decode_step,
    init_cache=transformer.init_cache,
    slice_params=transformer.slice_params,
    slice_cache=transformer.slice_cache,
    decode_embed=transformer.decode_embed,
    decode_stage=transformer.decode_stage,
    decode_unembed=transformer.decode_unembed,
    decode_slice_points=transformer.decode_slice_points,
    supports_bucketed_prefill=True,
)


def get_api(cfg: ModelConfig) -> ModelAPI:
    transformer.check_supported(cfg)
    return dataclasses.replace(_TRANSFORMER_API, family=cfg.family)
