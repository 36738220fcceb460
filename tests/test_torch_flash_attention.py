"""K1's plain version (tunevlseg_torch/ops/flash_attention.py) against the
JAX package's Pallas kernel `_forward_batched_heads`, run in interpret mode
on the CPU as tests/test_flash_attention.py runs it. The CUDA kernel itself
is checked on the card by tests/test_torch_gpu.py."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402

from tunevlseg_tpu.ops import flash_attention as jfa  # noqa: E402
from tunevlseg_torch.ops import flash_attention as fa  # noqa: E402


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jfa, "_INTERPRET", True)


def rand_qkv(seed, b, s, h, d, t):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, n, h, d)).astype(np.float32)
                 for n in (s, t, t))


# f32, the JAX kernel test's own tolerance (tests/test_flash_attention.py)
@pytest.mark.parametrize("b,s,h,d,t,kv_valid", [
    (2, 485, 3, 64, 485, None),   # vision shape, cut in batch and heads
    (2, 485, 3, 64, 512, 485),    # padded keys masked by kv_valid
    (2, 485, 4, 16, 485, None),   # decoder shape, cut in batch
])
def test_ref_matches_pallas_k1(b, s, h, d, t, kv_valid):
    q, k, v = rand_qkv(0, b, s, h, d, t)
    want = jfa._forward_batched_heads(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), kv_valid)
    got = fa.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), kv_valid)
    assert got.shape == (b, s, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-5, rtol=1e-4)


def test_cpu_wrapper_takes_plain_version():
    q, k, v = (torch.from_numpy(x) for x in rand_qkv(1, 1, 40, 2, 32, 40))
    before = fa.launch_count()
    got = fa.flash_attention(q, k, v, kv_valid=30)
    assert fa.launch_count() == before
    torch.testing.assert_close(got, fa.flash_attention_ref(q, k, v, 30),
                               rtol=0, atol=0)
    # masked keys get exactly zero probability: their values do not matter
    v2 = v.clone()
    v2[:, 30:] = 1e6
    torch.testing.assert_close(fa.flash_attention(q, k, v2, kv_valid=30), got,
                               rtol=0, atol=0)


def test_wrapper_rejects_bias_on_every_device():
    q, k, v = (torch.from_numpy(x) for x in rand_qkv(2, 1, 8, 1, 16, 8))
    with pytest.raises(ValueError, match="no bias"):
        fa.flash_attention(q, k, v, bias=torch.zeros(1, 1, 8, 8))


def test_kernel_checks_refuse_cpu_tensors():
    q, k, v = (torch.from_numpy(x).bfloat16() for x in rand_qkv(3, 1, 8, 1, 16, 8))
    with pytest.raises(ValueError, match="CUDA"):
        fa._check_kernel_inputs(q, k, v, None)
