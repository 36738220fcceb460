"""CLIPSeg segmentation model with a pluggable prompt learner.

Counterpart of `tunevlseg_tpu/models/clipseg/model.py`:
  * `learner=None` is the end-to-end HF CLIPSeg model;
  * a CoOp learner splices text contexts (COOPCLIPSeg). Text-only prompting
    builds the additive `use_new_last_layer` head in the reference but never
    applies it (`additive_mode="unused"`): only `residual_ratio` exists, as
    in the JAX param tree, and nothing reads it.

The vision tower runs first and exits after max(extract_layers), since no
ported learner reads pooled image features. `text_index` deduplicates
prompts: `input_ids` carries only the U unique rows, the text tower runs U
times and the conditioning is gathered back to B rows.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tunevlseg_torch.models.clip.config import CLIPSegConfig
from tunevlseg_torch.models.clip.text import CLIPTextTower
from tunevlseg_torch.models.clip.vision import CLIPVisionTower
from tunevlseg_torch.models.clipseg.decoder import CLIPSegDecoder
from tunevlseg_torch.models.prompt.learners import BasePromptLearner, PromptStacks
from tunevlseg_torch.nn.layers import Dense

ADDITIVE_MODES = ("none", "unused", "plain", "residual")


class CLIPSegForSegmentation(nn.Module):
    def __init__(self, config: CLIPSegConfig,
                 learner: Optional[BasePromptLearner] = None,
                 additive_mode: str = "none", dtype: torch.dtype = torch.float32):
        super().__init__()
        if additive_mode not in ADDITIVE_MODES:
            raise ValueError(f"additive_mode must be one of {ADDITIVE_MODES}")
        if additive_mode in ("plain", "residual"):
            raise NotImplementedError(
                f"additive_mode={additive_mode!r} needs the additive head, "
                "which comes with ROADMAP Slice B")
        c = self.config = config
        self.additive_mode = additive_mode
        self.text_model = CLIPTextTower(c.text, dtype)
        self.vision_model = CLIPVisionTower(c.vision, c.extract_layers,
                                            early_exit=True, dtype=dtype)
        self.text_projection = Dense(c.text.hidden_size, c.projection_dim,
                                     bias=False, dtype=dtype)
        self.decoder = CLIPSegDecoder(c, dtype)
        self.learner = learner
        if additive_mode == "unused":
            self.residual_ratio = nn.Parameter(torch.empty(()))

    def init_weights(self, generator: torch.Generator) -> None:
        if self.additive_mode == "unused":
            self.residual_ratio.fill_(0.5)  # the JAX default init

    def forward(self, input_ids: torch.Tensor, pixel_values: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                text_index: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """input_ids (B, L), or (U, L) with text_index (B,) into its rows;
        pixel_values (B, C, H, W). Returns logits (B, 1, H, W).
        `deterministic` and `generator` are the train step's dropout
        arguments; this model has no dropout and reads neither."""
        c = self.config
        b, _, h, w = pixel_values.shape
        learner = self.learner
        need_pooled = learner is not None and learner.needs_image_features
        if text_index is not None and need_pooled:
            raise ValueError(
                "text_index (prompt dedup) is incompatible with image-"
                "conditioned prompt learners (CoCoOp): the text stack is "
                "per-image, so unique prompt rows cannot be shared")
        if need_pooled or (learner is not None and learner.has_visual):
            raise NotImplementedError(
                f"{type(learner).__name__} comes with ROADMAP Slice B")

        stacks = learner() if learner is not None else PromptStacks()
        prompt_depth = learner.prompt_depth if learner is not None else 0

        hidden_states, _, _ = self.vision_model(pixel_values)
        activations = [hidden_states[i + 1] for i in c.extract_layers]

        _, pooled_text = self.text_model(input_ids, attention_mask=attention_mask,
                                         text_ctx=stacks.text,
                                         prompt_depth=prompt_depth)
        cond = self.text_projection(pooled_text)
        if text_index is not None:
            cond = cond[text_index]

        logits, _ = self.decoder(activations, cond)
        return logits.reshape(b, 1, h, w)


def strategy_additive_mode(strategy: Optional[str], use_new_last_layer: bool) -> str:
    """Map a prompt strategy to the reference's additive-head behavior."""
    if not use_new_last_layer:
        return "none"
    if strategy in (None, "e2e"):
        return "none"
    if strategy in ("coop", "cocoop"):
        return "unused"
    if strategy == "vpt":
        return "plain"
    return "residual"  # maple / shared_separate / shared_attn
