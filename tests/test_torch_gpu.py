"""Kernel K1 and the port's serving path on a CUDA GPU. These tests need the
card (a CUDA kernel has no CPU mode) and skip elsewhere; they import no JAX.
On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_*.py

(`--noconftest` because tests/conftest.py configures JAX, which the GPU
machine does not have; the JAX parity modules then skip themselves.)
"""
import pytest
import torch

from tunevlseg_torch.nn import attention
from tunevlseg_torch.ops import flash_attention as fa

pytestmark = pytest.mark.gpu

KERNEL_TOL = 2e-2  # bf16 output, a few ulp at |o| ~ 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: K1 is a CUDA kernel with no CPU mode")
    return torch.device("cuda")


def _qkv(cuda, b, s, h, d, t=None, dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return tuple(torch.randn(b, n, h, d, generator=g, device=cuda).to(dtype)
                 for n in (s, t or s, t or s))


@pytest.mark.parametrize("shape,t,kv_valid", [
    ((64, 485, 12, 64), 485, None),    # vision tower
    ((64, 485, 4, 16), 485, None),     # CLIPSeg decoder
    ((64, 512, 12, 64), 512, 485),     # padded keys masked by kv_valid
    ((3, 70, 2, 32), 130, 99),         # ragged tails, S != T
])
def test_k1_matches_plain_version(cuda, shape, t, kv_valid):
    q, k, v = _qkv(cuda, *shape, t=t)
    before = fa.launch_count()
    out = fa.flash_attention(q, k, v, kv_valid=kv_valid)
    torch.cuda.synchronize()
    assert fa.launch_count() == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    ref = fa.flash_attention_ref(q, k, v, kv_valid=kv_valid)
    assert (out.float() - ref.float()).abs().max().item() <= KERNEL_TOL


def test_k1_raises_on_what_it_does_not_take(cuda):
    q, k, v = _qkv(cuda, 2, 64, 2, 64)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention(q.float(), k.float(), v.float())
    q48, k48, v48 = _qkv(cuda, 2, 64, 2, 48)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q48, k48, v48)
    with pytest.raises(ValueError, match="no bias"):
        fa.flash_attention(q, k, v, bias=torch.zeros(1, 1, 64, 64, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    with pytest.raises(ValueError, match="kv_valid"):
        fa.flash_attention(q, k, v, kv_valid=0)


def test_k1_backward_is_not_ported(cuda):
    q, k, v = (x.requires_grad_() for x in _qkv(cuda, 1, 64, 2, 32))
    out = fa.flash_attention(q, k, v)
    with pytest.raises(NotImplementedError, match="K2"):
        out.float().sum().backward()


def test_gate_routes_only_unbiased_long_bf16(cuda):
    q, k, v = _qkv(cuda, 2, 256, 2, 32)
    before = fa.launch_count()
    attention.dot_product_attention(q, k, v)
    assert fa.launch_count() == before + 1
    short = _qkv(cuda, 2, 255, 2, 32)
    attention.dot_product_attention(*short)
    attention.dot_product_attention(q, k, v, bias=torch.zeros(1, 1, 256, 256,
                                                               device=cuda))
    attention.dot_product_attention(*(x.float() for x in (q, k, v)))
    assert fa.launch_count() == before + 1


def test_gate_raises_on_head_dim_k1_lacks(cuda):
    """The gate does not look at the head dim: an eligible call with a head
    dim K1 has no template for reaches K1 and raises."""
    q, k, v = _qkv(cuda, 2, 256, 2, 48)
    with pytest.raises(ValueError, match="head dims"):
        attention.dot_product_attention(q, k, v)


def test_small_model_kernel_path_matches_plain_path(cuda):
    """A narrow CLIPSeg + CoOp in bf16 at 256² (257 tokens, vision heads of
    32 dims, decoder heads of 16): 4 vision layers + 3 decoder blocks launch
    K1, and the probabilities agree with the all-plain path."""
    from unittest import mock

    from tunevlseg_tpu.models.clip.config import CLIPSegConfig, CLIPVisionConfig
    from tunevlseg_torch.models.presets import build_clipseg
    from tunevlseg_torch.training.task import SegmentationTask

    cfg = CLIPSegConfig.tiny(
        vision=CLIPVisionConfig(hidden_size=64, num_layers=4, num_heads=2,
                                intermediate_size=128, patch_size=16,
                                image_size=32),
        reduce_dim=32, decoder_num_heads=2)
    model = build_clipseg("coop", prompt_depth=3, num_context=4, config=cfg,
                          dtype=torch.bfloat16, device=cuda)
    task = SegmentationTask(model)
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(3, 999, (1, 77), generator=g, dtype=torch.int32)
    ids[:, 0], ids[:, 9:] = 49406, 49407
    batch = {"image": torch.randint(0, 256, (4, 3, 256, 256), generator=g,
                                    dtype=torch.uint8),
             "input_ids": ids, "attention_mask": (ids != 49407).int(),
             "text_index": torch.zeros(4, dtype=torch.int32)}
    batch = {k: x.to(cuda) for k, x in batch.items()}
    before = fa.launch_count()
    probs = task.predict_step(batch)
    assert fa.launch_count() == before + 7
    with mock.patch.object(attention, "_kernel_eligible", lambda *a: False):
        plain = task.predict_step(batch)
    assert probs.shape == (4, 1, 256, 256) and bool(probs.isfinite().all())
    assert (probs - plain).abs().max().item() <= 2e-2
