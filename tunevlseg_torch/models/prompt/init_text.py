"""Text-initialized context vectors.

The reference initializes CoOp/CoCoOp/MaPLe context vectors by embedding a
text initializer ("a photo of a") through the FROZEN token embedding,
tokenized WITHOUT special tokens; the token count then DEFINES num_context
(coop_context_learner.py:16-80). List initializers fill multiple depths;
remaining depths are N(0, std).

The port's own copy of `tunevlseg_tpu/models/prompt/init_text.py`.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np


def compute_initializer_embeddings(
    token_embedding: np.ndarray,     # (vocab, dim) converted embedding table
    tokenizer,
    context_initializer: Union[str, Sequence[str]],
) -> np.ndarray:
    """Returns (depth_init, num_context, dim)."""
    texts = ([context_initializer] if isinstance(context_initializer, str)
             else list(context_initializer))
    rows = []
    for text in texts:
        ids = tokenizer.encode(text, add_special_tokens=False)
        rows.append(np.asarray(token_embedding)[np.asarray(ids)])
    lengths = {r.shape[0] for r in rows}
    if len(lengths) != 1:
        raise ValueError(
            f"all context initializers must tokenize to the same length, "
            f"got {sorted(lengths)}")
    return np.stack(rows)
