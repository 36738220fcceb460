"""K3's plain version (`biased_attention_ref` in
tunevlseg_torch/ops/flash_attention.py) against the JAX package's Pallas
kernel `_forward`, run in interpret mode on the CPU as
tests/test_flash_attention.py runs it; the gradient of K3's
`autograd.Function` against `jax.grad` of `flash_attention_p` with a bias; and
the wrapper's checks. The CUDA kernel itself is held against the same plain
version on the card by tests/test_torch_gpu.py and chip_smoke.py."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402

from tunevlseg_tpu.ops import flash_attention as jfa  # noqa: E402
from tunevlseg_torch.nn import attention  # noqa: E402
from tunevlseg_torch.ops import flash_attention as fa  # noqa: E402

F32_MIN = np.finfo(np.float32).min


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jfa, "_INTERPRET", True)


def rand_qkv(seed, b, s, t, h, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, n, h, d)).astype(np.float32)
                 for n in (s, t, t))


def causal(s):
    return np.triu(np.full((s, s), F32_MIN, np.float32), k=1)[None, None]


def key_pad(b, t, first_pad):
    """(B, 1, 1, T) bias: row i pads its keys from first_pad - i on."""
    bias = np.zeros((b, 1, 1, t), np.float32)
    for i in range(b):
        bias[i, ..., first_pad - i:] = F32_MIN
    return bias


def causal_plus_pad(b, s, first_pad):
    # dtype-min + dtype-min overflows to -inf in f32, as in the text towers
    with np.errstate(over="ignore"):
        bias = causal(s) + key_pad(b, s, first_pad)
    assert np.isneginf(bias).any() and (bias == F32_MIN).any()
    return bias


def general_bias(b, h, s, t, seed=9):
    return np.random.default_rng(seed).normal(size=(b, h, s, t)).astype(np.float32)


def inf_prefix_bias(b, h, s, t):
    """A general bias with -inf over the first 64 keys in some rows and over
    the first 80 in others (a whole key tile of the kernel at -inf: the
    running maximum is -inf after it), finite keys after them."""
    bias = general_bias(b, h, s, t, seed=10)
    bias[:, :, ::3, :64] = -np.inf
    bias[:, :, 1::3, :80] = -np.inf
    return bias


def min_row_bias(b, h, s, t):
    """Key padding, with some rows entirely at dtype-min: those rows keep a
    uniform p over their keys, as the Pallas kernel gives them."""
    bias = np.broadcast_to(key_pad(b, t, t - 20), (b, h, s, t)).copy()
    bias[:, :, ::5] = F32_MIN
    return bias


CASES = {
    # label: (b, s, t, h, d, bias maker, kv_valid)
    "text causal+pad 77": (2, 77, 77, 2, 64, lambda: causal_plus_pad(2, 77, 12), None),
    "text causal+pad d32": (2, 77, 77, 2, 32, lambda: causal_plus_pad(2, 77, 30), None),
    "cross 40x77 key-pad": (3, 40, 77, 2, 64, lambda: key_pad(3, 77, 20), None),
    "cross 40x77 key-pad d16": (3, 40, 77, 4, 16, lambda: key_pad(3, 77, 20), None),
    "no bias, S != T": (2, 40, 77, 2, 32, lambda: None, None),
    "no bias, kv_valid < T": (2, 40, 77, 2, 32, lambda: None, 60),
    "key-pad and kv_valid": (2, 40, 77, 2, 64, lambda: key_pad(2, 77, 50), 70),
    "full (B,H,S,T) bias": (2, 24, 40, 2, 16, lambda: general_bias(2, 2, 24, 40), None),
    # the Hopper kernel's tile edges: 128 query rows a tile, 80 keys a tile,
    # up to two key tiles resident, the keys' maps ending at kv_valid
    "two query tiles S=129": (2, 129, 77, 2, 64, lambda: key_pad(2, 77, 30), None),
    "T=65 d64": (2, 40, 65, 2, 64, lambda: key_pad(2, 65, 60), None),
    "T=80 d32, one full key tile": (2, 40, 80, 2, 32, lambda: key_pad(2, 80, 79), None),
    "T=81 d16, one key past a tile": (2, 40, 81, 2, 16, lambda: key_pad(2, 81, 81), None),
    "T=128 d64": (2, 40, 128, 2, 64, lambda: general_bias(2, 2, 40, 128), None),
    "T=129 d32": (2, 40, 129, 2, 32, lambda: key_pad(2, 129, 100), None),
    "kv_valid 80 at a key-tile edge": (2, 40, 129, 2, 64, lambda: key_pad(2, 129, 120), 80),
    "kv_valid 64, no bias": (2, 40, 129, 2, 16, lambda: None, 64),
    "-inf over a key tile": (2, 40, 129, 2, 64, lambda: inf_prefix_bias(2, 2, 40, 129), None),
    "rows entirely dtype-min": (2, 40, 77, 2, 32, lambda: min_row_bias(2, 2, 40, 77), None),
}


# f32 within 1e-5: the same formula, sums taken in another order
@pytest.mark.parametrize("label", list(CASES))
def test_ref_matches_pallas_k3_f32(label):
    b, s, t, h, d, make_bias, kv_valid = CASES[label]
    q, k, v = rand_qkv(0, b, s, t, h, d)
    bias = make_bias()
    want = jfa._forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        None if bias is None else jnp.asarray(bias), kv_valid)
    got = fa.biased_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if bias is None else torch.from_numpy(bias), kv_valid)
    assert got.shape == (b, s, h, d) and bool(got.isfinite().all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # and the CPU wrapper is that plain version, with no launch counted
    before = fa.bias_launch_count()
    again = fa.biased_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if bias is None else torch.from_numpy(bias), kv_valid)
    assert fa.bias_launch_count() == before
    torch.testing.assert_close(again, got, rtol=0, atol=0)


# bf16 within 2e-2: p is rounded to bf16 at the same place in both, the
# output once; a few bf16 ulp at |o| ~ 1
@pytest.mark.parametrize("label", ["text causal+pad 77", "cross 40x77 key-pad",
                                   "cross 40x77 key-pad d16",
                                   "text causal+pad d32", "two query tiles S=129",
                                   "-inf over a key tile", "rows entirely dtype-min"])
def test_ref_matches_pallas_k3_bf16(label):
    b, s, t, h, d, make_bias, kv_valid = CASES[label]
    q, k, v = rand_qkv(1, b, s, t, h, d)
    bias = make_bias()
    want = jfa._forward(*(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
                        jnp.asarray(bias), kv_valid)
    got = fa.biased_attention_ref(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
        torch.from_numpy(bias), kv_valid)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2e-2)


def test_masked_keys_get_exactly_zero_probability():
    q, k, v = (torch.from_numpy(x) for x in rand_qkv(2, 2, 40, 77, 2, 32))
    bias = torch.from_numpy(key_pad(2, 77, 50))
    got = fa.biased_attention(q, k, v, bias, kv_valid=70)
    v2 = v.clone()
    v2[:, 70:] = 1e6        # behind kv_valid
    v2[0, 50:] = 1e6        # behind sample 0's key padding
    v2[1, 49:] = 1e6
    torch.testing.assert_close(fa.biased_attention(q, k, v2, bias, kv_valid=70),
                               got, rtol=0, atol=0)


@pytest.mark.parametrize("label", ["text causal+pad d32", "cross 40x77 key-pad d16",
                                   "key-pad and kv_valid"])
def test_function_gradient_matches_jax_grad(label):
    """The `autograd.Function` around K3 (forward: the plain version here on
    the CPU; backward: a recompute through `plain_attention`) against
    `jax.grad` of `flash_attention_p` with the same bias, whose backward
    recomputes through the plain JAX attention: f32 within 1e-4."""
    b, s, t, h, d, make_bias, kv_valid = CASES[label]
    q, k, v = rand_qkv(3, b, s, t, h, d)
    g = np.random.default_rng(4).normal(size=(b, s, h, d)).astype(np.float32)
    bias = make_bias()

    def loss(q, k, v):
        return jnp.sum(jfa.flash_attention_p(kv_valid, q, k, v,
                                             jnp.asarray(bias)) * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    qkv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fa.biased_attention(*qkv, torch.from_numpy(bias), kv_valid)
    assert out.grad_fn is not None and "BiasedAttention" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, qkv, torch.from_numpy(g))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_function_saves_nothing_without_a_gradient():
    q, k, v = (torch.from_numpy(x) for x in rand_qkv(5, 1, 8, 12, 1, 16))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda x: saved.append(x.shape) or x, lambda x: x):
        fa.biased_attention(q, k, v, torch.zeros(1, 1, 1, 12))
    assert saved == []


def test_bias_takes_no_gradient():
    q, k, v = (torch.from_numpy(x) for x in rand_qkv(6, 1, 8, 12, 1, 16))
    with pytest.raises(ValueError, match="no gradient"):
        fa.biased_attention(q, k, v, torch.zeros(1, 1, 8, 12, requires_grad=True))


def test_bias_strides_are_zero_on_broadcast_dimensions():
    """The wrapper's check of a bias (`_check_bias`, before the op) and the
    strides K3's launcher passes (`_bias_strides`)."""
    q = torch.zeros(4, 10, 2, 16)
    for bias, strides in ((torch.zeros(4, 1, 1, 7), [7, 0, 0, 1]),
                          (torch.zeros(1, 1, 10, 7), [0, 0, 7, 1]),
                          (torch.zeros(1, 2, 1, 7).expand(4, 2, 10, 7), [0, 7, 0, 1])):
        fa._check_bias(bias, q, 7)
        assert list(fa._bias_strides(bias)) == strides
    with pytest.raises(ValueError, match="broadcast"):
        fa._check_bias(torch.zeros(4, 1, 3, 7), q, 7)
    with pytest.raises(ValueError, match="float32"):
        fa._check_bias(torch.zeros(4, 1, 1, 7, dtype=torch.bfloat16), q, 7)


def test_gate_keeps_cpu_and_f32_on_the_plain_path(monkeypatch):
    """CPU tensors never reach a kernel wrapper, with or without a bias."""
    def boom(*a, **kw):
        raise AssertionError("a kernel wrapper was called for a CPU tensor")

    monkeypatch.setattr(attention, "biased_attention", boom)
    monkeypatch.setattr(attention, "flash_attention", boom)
    q, k, v = (torch.from_numpy(x) for x in rand_qkv(7, 1, 300, 300, 1, 16))
    bias = torch.zeros(1, 1, 1, 300)
    for x in (q, q.bfloat16()):
        args = (x, k.to(x.dtype), v.to(x.dtype))
        assert attention._kernel_eligible(*args[:2], bias) == ""
        assert attention._kernel_eligible(*args[:2], None) == ""
        attention.dot_product_attention(*args, bias=bias)
        attention.dot_product_attention(*args)


def test_reset_sets_the_k3_launch_count_to_zero():
    fa.reset_launch_count()
    assert fa.bias_launch_count() == 0


def test_k3_runs_wgmma_from_tma_with_no_mma_sync():
    """K3 (csrc/flash_attn_bias_fwd.cu) runs both products on wgmma from
    shared memory that a producer warp fills by TMA, on the building blocks
    in csrc/attn_hopper.cuh, with no mma.sync path left; the headers it
    includes are part of its library's build hash. The TMA loads and the
    P V product go through attn_hopper.cuh's column-chunk helpers (one
    chunk at D <= 64, three of 32 at D = 96), which issue `tma_load_4d` and
    `wgmma_rs`."""
    from tunevlseg_torch.ops import build
    source = build.SOURCES["bias"]
    text = source.read_text()
    for needed in ("tma_load_rows<D>", "mbar_wait", "wgmma_m64k16<kBN>",
                   "wgmma_rs_cols<D>", "acc_to_a<kBN>",
                   '#include "attn_fwd_hopper.cuh"'):
        assert needed in text, needed
    blocks = (source.parent / "attn_hopper.cuh").read_text()
    for needed in ("tma_load_4d(dst + c * pitch", "wgmma_rs<C::kW, 1>"):
        assert needed in blocks, needed
    for gone in ("mma.sync", "mma_bf16_16816", "load_tile", "pack_raw"):
        assert gone not in text, gone
    csrc = source.parent
    assert "kBN = 80;" in text and "wgmma_m64n80k16" in (csrc / "hopper.cuh").read_text()
    for header in ("attn_fwd_hopper.cuh", "attn_hopper.cuh", "attn_common.cuh",
                   "hopper.cuh"):
        assert csrc / header in build.HEADERS
    # the helpers only the mma.sync design used are gone from the shared header
    common = (csrc / "attn_common.cuh").read_text()
    assert "mma.sync" not in common and "load_tile" not in common
