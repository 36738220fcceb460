"""Prompt-strategy context learners.

Counterpart of `tunevlseg_tpu/models/prompt/learners.py`. Every learner owns
`context_vectors` (prompt_depth, num_context, context_dim), initialised
N(0, vector_std) or from embedded text, and returns its whole per-depth
context stack at once as `PromptStacks`; the towers read `stack[i]` in their
layer loops. The six strategies: CoOp (textual contexts), CoCoOp (textual
contexts plus a per-image bias from a meta-net over pooled image features),
VPT (visual contexts), MaPLe (textual contexts and their per-depth projection
to the vision width), Shared-Separate (low-dimensional shared contexts
projected to both widths) and Shared-Attention (joint-width contexts through
a transformer layer, split into the two halves).

Flax names are kept (`proj_0`, `text_proj_1`, `hidden_0`, `out`, `norm`,
`down`, `up`, `norm1`, `self_attn`, `linear1`), so the weight mapping stays
mechanical. The projectors' LayerNorms use eps 1e-5 (torch's default, not the
towers' config value). Dropout exists in the Shared-Attention projector only
(0.25); it is applied with `deterministic=False` and draws its masks from the
generator it is given, as the CRIS decoder's does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tunevlseg_torch.nn.layers import (ACT2FN, Dense, LayerNorm,
                                       MultiHeadAttention, dropout)


class PromptStacks(NamedTuple):
    """Per-depth context tensors for each modality (None = modality unused)."""

    text: Optional[torch.Tensor] = None    # (D, n, td) or (D, B, n, td)
    visual: Optional[torch.Tensor] = None  # (D, n, vd)


def context_vectors_init(prompt_depth: int, num_context: int, context_dim: int,
                         generator: torch.Generator, vector_std: float = 0.02,
                         initializer_embeddings: Optional[np.ndarray] = None
                         ) -> torch.Tensor:
    """N(0, vector_std) context vectors whose leading depths are overwritten
    by the token-embedded initializer text ((n, d) or (depth_init, n, d))."""
    vecs = vector_std * torch.randn(prompt_depth, num_context, context_dim,
                                    generator=generator)
    if initializer_embeddings is not None:
        emb = torch.as_tensor(np.asarray(initializer_embeddings), dtype=vecs.dtype)
        if emb.dim() == 2:
            emb = emb[None]
        d = min(emb.shape[0], prompt_depth)
        vecs[:d] = emb[:d]
    return vecs


class _KaimingDense(Dense):
    """A projector's hidden layer: Kaiming-normal weight (variance 2 / fan_in)."""

    def init_weights(self, generator: torch.Generator) -> None:
        self.weight.normal_(0.0, (2.0 / self.weight.shape[1]) ** 0.5,
                            generator=generator)
        self.bias.zero_()


class MLPProjector(nn.Module):
    """One Linear when `intermediate_dims` is empty (`use_final_norm` and
    `use_final_bias` are then ignored, as in the reference), else Linear ->
    ReLU stacks, an output Linear (without bias under a final norm) and an
    optional final LayerNorm (whose bias follows `use_final_bias`)."""

    def __init__(self, in_dim: int, out_dim: int,
                 intermediate_dims: Sequence[int] = (),
                 use_final_norm: bool = False, use_final_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dims = [in_dim, *intermediate_dims]
        for i, (a, b) in enumerate(zip(dims, dims[1:])):
            self.add_module(f"hidden_{i}", _KaimingDense(a, b, dtype=dtype))
        self.num_hidden = len(dims) - 1
        bare = not intermediate_dims
        self.out = Dense(dims[-1], out_dim, dtype=dtype,
                         bias=bare or ((not use_final_norm) and use_final_bias))
        self.norm = (LayerNorm(out_dim, 1e-5, dtype, bias=use_final_bias)
                     if use_final_norm and not bare else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_hidden):
            x = F.relu(getattr(self, f"hidden_{i}")(x))
        x = self.out(x)
        return x if self.norm is None else self.norm(x)


class LoRAProjector(nn.Module):
    """A low-rank Linear pair: `down` (no bias) to min(out_dim, rank), `up`
    when rank <= out_dim, and the optional final LayerNorm."""

    def __init__(self, in_dim: int, out_dim: int, rank: int,
                 use_final_norm: bool = False, use_final_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        min_dim = min(out_dim, rank)
        self.down = Dense(in_dim, min_dim, bias=False, dtype=dtype)
        self.up = (Dense(min_dim, out_dim, dtype=dtype,
                         bias=(not use_final_norm) and use_final_bias)
                   if rank <= out_dim else None)
        # without `up`, min_dim is out_dim: the norm's width either way
        self.norm = (LayerNorm(out_dim, 1e-5, dtype, bias=use_final_bias)
                     if use_final_norm else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.down(x)
        if self.up is not None:
            x = self.up(x)
        return x if self.norm is None else self.norm(x)


class TorchTransformerEncoderLayer(nn.Module):
    """`torch.nn.TransformerEncoderLayer` semantics (the Shared-Attention
    projector: 16 heads, feed-forward 1536, dropout 0.25, norm first,
    sequence first). Inputs are (seq, batch, d); the learner feeds
    (1, n_ctx, d), so self-attention runs over a length-1 sequence per
    context slot: its softmax is 1 and the q and k projections get a
    gradient of exactly zero."""

    def __init__(self, dim: int, num_heads: int, dim_feedforward: int,
                 dropout_rate: float = 0.0, norm_first: bool = True,
                 activation: str = "relu", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.norm_first = norm_first
        self.act = ACT2FN[activation]
        self.norm1 = LayerNorm(dim, 1e-5, dtype)
        self.norm2 = LayerNorm(dim, 1e-5, dtype)
        self.self_attn = MultiHeadAttention(dim, num_heads, dtype)
        self.linear1 = Dense(dim, dim_feedforward, dtype=dtype)
        self.linear2 = Dense(dim_feedforward, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        def drop(h):
            return dropout(h, self.dropout_rate, deterministic, generator)

        def sa(h):      # attention over the seq axis, batch-first for the MHA
            return self.self_attn(h.transpose(0, 1)).transpose(0, 1)

        def ff(h):
            return self.linear2(drop(self.act(self.linear1(h))))

        if self.norm_first:
            x = x + drop(sa(self.norm1(x)))
            return x + drop(ff(self.norm2(x)))
        x = self.norm1(x + drop(sa(x)))
        return self.norm2(x + drop(ff(x)))


def _make_projector(in_dim: int, out_dim: int, intermediate_dims: Sequence[int],
                    use_proj_norm: bool, use_lora_proj: bool,
                    use_final_bias: bool, dtype: torch.dtype) -> nn.Module:
    if use_lora_proj and intermediate_dims:
        return LoRAProjector(in_dim, out_dim, intermediate_dims[0],
                             use_proj_norm, use_final_bias, dtype)
    return MLPProjector(in_dim, out_dim, tuple(intermediate_dims),
                        use_proj_norm, use_final_bias, dtype)


class BasePromptLearner(nn.Module):
    has_text = False
    has_visual = False
    needs_image_features = False  # CoCoOp: the text stack is image-conditioned

    def __init__(self, prompt_depth: int = 1, num_context: int = 4,
                 context_dim: int = 512, vector_std: float = 0.02,
                 initializer_embeddings: Optional[np.ndarray] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.prompt_depth = prompt_depth
        self.num_context = num_context
        self.vector_std = vector_std
        self.initializer_embeddings = initializer_embeddings
        self.dtype = dtype
        self.context_vectors = nn.Parameter(
            torch.empty(prompt_depth, num_context, context_dim))

    def init_weights(self, generator: torch.Generator) -> None:
        d, n, dim = self.context_vectors.shape
        self.context_vectors.copy_(context_vectors_init(
            d, n, dim, generator, self.vector_std, self.initializer_embeddings))

    @staticmethod
    def check_depth(prompt_depth: int, max_network_depth: int) -> None:
        if not 1 <= prompt_depth <= max_network_depth:
            raise ValueError(
                f"prompt_depth={prompt_depth} must be in [1, {max_network_depth}]")


class CoOpLearner(BasePromptLearner):
    """Textual-only contexts."""

    has_text = True

    def forward(self, image_features=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> PromptStacks:
        return PromptStacks(text=self.context_vectors.to(self.dtype))


class _ProjectedLearner(BasePromptLearner):
    """A learner with one projector per depth under `<prefix>_<i>`, or one
    shared by every depth with `use_unified_projection`."""

    def _add_projectors(self, prefix: str, in_dim: int, out_dim: int,
                        use_unified_projection: bool, make) -> None:
        self.n_proj = 1 if use_unified_projection else self.prompt_depth
        for i in range(self.n_proj):
            self.add_module(f"{prefix}_{i}", make(in_dim, out_dim))

    def _projector(self, prefix: str, depth: int) -> nn.Module:
        return getattr(self, f"{prefix}_{0 if self.n_proj == 1 else depth}")


class CoCoOpLearner(_ProjectedLearner):
    """Image-conditioned textual contexts: a meta-net projects the pooled
    image features to a per-sample bias that is added to every context token.
    Its projector has no final bias anywhere. The text stack is
    (depth, B, n, context_dim)."""

    has_text = True
    needs_image_features = True

    def __init__(self, visual_dim: int = 512, norm_image_features: bool = True,
                 use_unified_projection: bool = True,
                 intermediate_dims: Sequence[int] = (),
                 use_proj_norm: bool = False, use_lora_proj: bool = False,
                 **base):
        super().__init__(**base)
        self.norm_image_features = norm_image_features
        dim = self.context_vectors.shape[-1]
        self._add_projectors(
            "proj", visual_dim, dim, use_unified_projection,
            lambda a, b: _make_projector(a, b, intermediate_dims, use_proj_norm,
                                         use_lora_proj, False, self.dtype))

    def forward(self, image_features=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> PromptStacks:
        if image_features is None:
            raise ValueError("CoCoOp requires pooled image features")
        ctx = self.context_vectors.to(self.dtype)               # (D, n, td)
        feats = image_features.to(self.dtype)                   # (B, vd)
        if self.norm_image_features:
            feats = feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
        biases = [self._projector("proj", i)(feats) for i in range(self.n_proj)]
        if self.n_proj == 1:
            biases = biases * self.prompt_depth
        bias = torch.stack(biases)                              # (D, B, td)
        # (D, 1, n, td) + (D, B, 1, td) -> (D, B, n, td)
        return PromptStacks(text=ctx[:, None] + bias[:, :, None, :])


class VPTLearner(BasePromptLearner):
    """Visual-only contexts, appended after the patch tokens."""

    has_visual = True

    def forward(self, image_features=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> PromptStacks:
        return PromptStacks(visual=self.context_vectors.to(self.dtype))


class MapleLearner(_ProjectedLearner):
    """MaPLe: the textual contexts are the parameters; the visual contexts
    are a per-depth projection of them."""

    has_text = True
    has_visual = True

    def __init__(self, visual_dim: int = 768, use_unified_projection: bool = True,
                 intermediate_dims: Sequence[int] = (),
                 use_proj_norm: bool = False, use_lora_proj: bool = False,
                 **base):
        super().__init__(**base)
        self._add_projectors(
            "proj", self.context_vectors.shape[-1], visual_dim,
            use_unified_projection,
            lambda a, b: _make_projector(a, b, intermediate_dims, use_proj_norm,
                                         use_lora_proj, True, self.dtype))

    def forward(self, image_features=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> PromptStacks:
        ctx = self.context_vectors.to(self.dtype)               # (D, n, td)
        visual = torch.stack([self._projector("proj", i)(ctx[i])
                              for i in range(self.prompt_depth)])   # (D, n, vd)
        return PromptStacks(text=ctx, visual=visual)


class SharedSeparateLearner(_ProjectedLearner):
    """Shared low-dimensional latent contexts (`context_dim`, 64 by default)
    and two per-depth projector stacks to the textual and visual widths."""

    has_text = True
    has_visual = True

    def __init__(self, textual_dim: int = 512, visual_dim: int = 768,
                 use_unified_projection: bool = True,
                 intermediate_dims: Sequence[int] = (),
                 use_proj_norm: bool = False, use_lora_proj: bool = False,
                 **base):
        super().__init__(**base)
        shared = self.context_vectors.shape[-1]

        def make(a, b):
            return _make_projector(a, b, intermediate_dims, use_proj_norm,
                                   use_lora_proj, True, self.dtype)

        self._add_projectors("text_proj", shared, textual_dim,
                             use_unified_projection, make)
        self._add_projectors("visual_proj", shared, visual_dim,
                             use_unified_projection, make)

    def forward(self, image_features=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> PromptStacks:
        ctx = self.context_vectors.to(self.dtype)               # (D, n, shared)
        depths = range(self.prompt_depth)
        return PromptStacks(
            text=torch.stack([self._projector("text_proj", i)(ctx[i])
                              for i in depths]),
            visual=torch.stack([self._projector("visual_proj", i)(ctx[i])
                                for i in depths]))


class SharedAttnLearner(_ProjectedLearner):
    """Shared (textual_dim + visual_dim)-wide contexts through a per-depth
    transformer layer; the output splits into the text half and the vision
    half. Computed once per step. `context_dim` must equal textual_dim +
    visual_dim."""

    has_text = True
    has_visual = True

    def __init__(self, textual_dim: int = 512, visual_dim: int = 768,
                 use_unified_projection: bool = True, proj_num_heads: int = 16,
                 proj_dim_feedforward: int = 1536, proj_dropout: float = 0.25,
                 proj_norm_first: bool = True, **base):
        super().__init__(**base)
        self.textual_dim = textual_dim
        dim = self.context_vectors.shape[-1]
        if dim != textual_dim + visual_dim:
            raise ValueError("context_dim must be textual_dim + visual_dim")
        self._add_projectors(
            "proj", dim, dim, use_unified_projection,
            lambda a, b: TorchTransformerEncoderLayer(
                a, proj_num_heads, proj_dim_feedforward, proj_dropout,
                proj_norm_first, dtype=self.dtype))

    def forward(self, image_features=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> PromptStacks:
        ctx = self.context_vectors.to(self.dtype)               # (D, n, td+vd)
        # (1, n, d) is (seq = 1, batch = n): one key per context slot
        combined = torch.stack([
            self._projector("proj", i)(ctx[i][None], deterministic, generator)[0]
            for i in range(self.prompt_depth)])
        return PromptStacks(text=combined[..., :self.textual_dim],
                            visual=combined[..., self.textual_dim:])


LEARNER_REGISTRY = {
    "coop": CoOpLearner,
    "cocoop": CoCoOpLearner,
    "vpt": VPTLearner,
    "maple": MapleLearner,
    "shared_separate": SharedSeparateLearner,
    "shared_attn": SharedAttnLearner,
}
