"""CLIPSeg segmentation model with a pluggable prompt learner.

Counterpart of `tunevlseg_tpu/models/clipseg/model.py`:
  * `learner=None` is the end-to-end HF CLIPSeg model;
  * a CoOp or CoCoOp learner splices text contexts. Text-only prompting
    builds the additive `use_new_last_layer` head in the reference but never
    applies it (`additive_mode="unused"`): only `residual_ratio` exists, as
    in the JAX param tree, and nothing reads it;
  * VPT appends visual contexts and adds the additive head without a ratio
    (`additive_mode="plain"`: logits + head);
  * MaPLe and the two shared learners prompt both towers and blend
    (`"residual"`: (1 - r) * logits + r * head).

Order of a forward: the learner's stacks (once per step, unless they are
image-conditioned) -> vision tower -> for CoCoOp the pooled output through
`visual_projection` into the learner -> text tower -> text projection ->
decoder -> additive head. The vision tower exits after max(extract_layers)
unless the learner reads pooled image features; `visual_projection`, the last
vision layers and `post_layernorm` exist only then, and `additive_head` only
under "plain" / "residual", as in the JAX param tree. `text_index`
deduplicates prompts: `input_ids` carries only the U unique rows, the text
tower runs U times and the conditioning is gathered back to B rows; CoCoOp's
text stack is per image, so it runs the text tower on B rows and raises on
`text_index`.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tunevlseg_torch.models.clip.config import CLIPSegConfig
from tunevlseg_torch.models.clip.text import CLIPTextTower
from tunevlseg_torch.models.clip.vision import CLIPVisionTower
from tunevlseg_torch.models.clipseg.decoder import AdditiveHead, CLIPSegDecoder
from tunevlseg_torch.models.prompt.learners import BasePromptLearner, PromptStacks
from tunevlseg_torch.nn.layers import Dense

ADDITIVE_MODES = ("none", "unused", "plain", "residual")


class CLIPSegForSegmentation(nn.Module):
    def __init__(self, config: CLIPSegConfig,
                 learner: Optional[BasePromptLearner] = None,
                 additive_mode: str = "none", additive_kernel_size: int = 5,
                 residual_ratio_init: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if additive_mode not in ADDITIVE_MODES:
            raise ValueError(f"additive_mode must be one of {ADDITIVE_MODES}")
        c = self.config = config
        self.additive_mode = additive_mode
        self.residual_ratio_init = residual_ratio_init
        need_pooled = learner is not None and learner.needs_image_features
        self.text_model = CLIPTextTower(c.text, dtype)
        self.vision_model = CLIPVisionTower(c.vision, c.extract_layers,
                                            early_exit=not need_pooled,
                                            dtype=dtype)
        self.text_projection = Dense(c.text.hidden_size, c.projection_dim,
                                     bias=False, dtype=dtype)
        if need_pooled:
            self.visual_projection = Dense(c.vision.hidden_size,
                                           c.projection_dim, bias=False,
                                           dtype=dtype)
        self.decoder = CLIPSegDecoder(c, dtype)
        self.learner = learner
        if additive_mode in ("plain", "residual"):
            self.additive_head = AdditiveHead(c, additive_kernel_size, dtype)
        if additive_mode != "none":
            self.residual_ratio = nn.Parameter(torch.empty(()))

    def init_weights(self, generator: torch.Generator) -> None:
        if self.additive_mode != "none":
            self.residual_ratio.fill_(self.residual_ratio_init)

    def unused_parameters(self) -> list[str]:
        """The parameters the forward never reads (data parallel sets DDP's
        `find_unused_parameters` by them): `residual_ratio` unless the
        additive head is "residual"."""
        return (["residual_ratio"] if self.additive_mode in ("unused", "plain")
                else [])

    def forward(self, input_ids: torch.Tensor, pixel_values: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                text_index: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """input_ids (B, L), or (U, L) with text_index (B,) into its rows;
        pixel_values (B, C, H, W). Returns logits (B, 1, H, W).
        `deterministic` and `generator` are the train step's dropout
        arguments: only the Shared-Attention learner's projector has dropout."""
        c = self.config
        b, _, h, w = pixel_values.shape
        learner = self.learner
        need_pooled = learner is not None and learner.needs_image_features
        has_text = learner is not None and learner.has_text
        prompt_depth = learner.prompt_depth if learner is not None else 0
        if text_index is not None and need_pooled:
            raise ValueError(
                "text_index (prompt dedup) is incompatible with image-"
                "conditioned prompt learners (CoCoOp): the text stack is "
                "per-image, so unique prompt rows cannot be shared")

        stacks = PromptStacks()
        if learner is not None and not need_pooled:
            stacks = learner(deterministic=deterministic, generator=generator)
        visual_ctx = stacks.visual

        hidden_states, _, pooled_vis = self.vision_model(
            pixel_values, visual_ctx=visual_ctx, prompt_depth=prompt_depth)
        activations = [hidden_states[i + 1] for i in c.extract_layers]

        if need_pooled:
            stacks = learner(image_features=self.visual_projection(pooled_vis),
                             deterministic=deterministic, generator=generator)

        _, pooled_text = self.text_model(
            input_ids, attention_mask=attention_mask,
            text_ctx=stacks.text if has_text else None,
            prompt_depth=prompt_depth)
        cond = self.text_projection(pooled_text)
        if text_index is not None:
            cond = cond[text_index]

        num_visual_ctx = visual_ctx.shape[-2] if visual_ctx is not None else 0
        logits, feat = self.decoder(activations, cond,
                                    num_visual_ctx=num_visual_ctx)
        if self.additive_mode == "plain":
            logits = logits + self.additive_head(feat)
        elif self.additive_mode == "residual":
            r = self.residual_ratio.to(logits.dtype)
            logits = (1 - r) * logits + r * self.additive_head(feat)
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
