"""Prompt-strategy context learners.

Counterpart of `tunevlseg_tpu/models/prompt/learners.py`. Every learner owns
`context_vectors` (prompt_depth, num_context, context_dim), initialised
N(0, vector_std) or from embedded text, and returns its whole per-depth
context stack at once as `PromptStacks`; the towers read `stack[i]` in their
layer loops. Only CoOp (textual contexts) is ported; CoCoOp, VPT, MaPLe and
the two shared learners come with ROADMAP Slice B.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn


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

    def forward(self, image_features=None) -> PromptStacks:
        return PromptStacks(text=self.context_vectors.to(self.dtype))
