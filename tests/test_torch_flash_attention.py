"""K1's and K2's plain versions (tunevlseg_torch/ops/flash_attention.py)
against the JAX package's Pallas kernels `_forward_batched_heads` and
`_backward_batched_heads`, run in interpret mode on the CPU as
tests/test_flash_attention.py runs them. The CUDA kernels themselves are
checked on the card by tests/test_torch_gpu.py."""
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
    # the tile edges the kernel masks: 128 query rows a block, 64 keys a tile
    (2, 129, 3, 32, 129, None),   # one query row past a block
    (2, 129, 2, 16, 65, 64),      # one key past a tile, masked; S != T
    (2, 129, 3, 64, 65, 65),      # one key past a tile, valid
    (1, 129, 3, 64, 129, 64),     # kv_valid at a tile edge
    (2, 70, 2, 32, 65, 65),       # S > T
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


# --- K2: the plain version of the backward against the Pallas backward -----

def rand_g(seed, b, s, h, d):
    return np.random.default_rng(seed).normal(size=(b, s, h, d)).astype(np.float32)


# f32 at the JAX backward test's own tolerance (tests/test_flash_attention.py,
# test_pallas_backward_direct): the same formulas, sums taken in another order
@pytest.mark.parametrize("b,s,h,d,t,kv_valid", [
    (2, 200, 4, 32, 200, None),   # the JAX test's own shape
    (1, 485, 3, 64, 485, None),   # vision shape, cut in batch and heads
    (2, 485, 4, 16, 485, None),   # decoder shape, cut in batch
    (1, 512, 3, 64, 512, 485),    # padded keys masked by kv_valid
])
def test_bwd_ref_matches_pallas_k2(b, s, h, d, t, kv_valid):
    """Both forms of the plain version: from q, k, v and g alone, and K2's
    own with p from the forward's log-sum-exp."""
    q, k, v = rand_qkv(4, b, s, h, d, t)
    g = rand_g(5, b, s, h, d)
    want = jfa._backward_batched_heads(*(jnp.asarray(x) for x in (q, k, v, g)),
                                       kv_valid)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    _, lse = fa.flash_attention_ref(tq, tk, tv, kv_valid, return_lse=True)
    for got in (fa.flash_attention_bwd_ref(tq, tk, tv, tg, kv_valid),
                fa.flash_attention_bwd_ref(tq, tk, tv, tg, kv_valid, lse=lse)):
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            assert a.shape == w.shape, name
            np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-4,
                                       rtol=1e-3, err_msg=name)
        if kv_valid is not None:
            # masked keys: exactly zero dk and dv rows, in both packages
            for a, w in zip(got[1:], want[1:]):
                assert (a[:, kv_valid:] == 0).all()
                assert (np.asarray(w)[:, kv_valid:] == 0).all()
                assert (a[:, :kv_valid] != 0).any()


def test_bwd_ref_bf16_matches_pallas_k2():
    """bf16 at the vision shape: p and ds are rounded to bf16 at the same
    places in both; atol 5e-2 is the JAX bf16 backward test's own."""
    q, k, v = rand_qkv(6, 1, 485, 3, 64, 485)
    g = rand_g(7, 1, 485, 3, 64)
    want = jfa._backward_batched_heads(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v, g)))
    tq, tk, tv, tg = (torch.from_numpy(x).bfloat16() for x in (q, k, v, g))
    o, lse = fa.flash_attention_ref(tq, tk, tv, return_lse=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    for got in (fa.flash_attention_bwd_ref(tq, tk, tv, tg),
                fa.flash_attention_bwd_ref(tq, tk, tv, tg, lse=lse)):
        for a, w in zip(got, want):
            assert a.dtype == torch.bfloat16
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(w, np.float32), atol=5e-2)


def test_cpu_bwd_wrapper_takes_plain_version():
    q, k, v = (torch.from_numpy(x) for x in rand_qkv(8, 1, 40, 2, 32, 40))
    g = torch.from_numpy(rand_g(9, 1, 40, 2, 32))
    before = fa.bwd_launch_count()
    got = fa.flash_attention_bwd(q, k, v, g, kv_valid=30)
    assert fa.bwd_launch_count() == before
    for a, w in zip(got, fa.flash_attention_bwd_ref(q, k, v, g, 30)):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    # and it is the gradient of the plain forward (f32: 1e-5, summation order)
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    auto = torch.autograd.grad(fa.flash_attention_ref(*qkv, 30), qkv, g)
    for a, w in zip(got, auto):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("b,s,h,d,t,kv_valid", [
    (2, 485, 3, 64, 485, None), (2, 70, 2, 16, 130, 99), (1, 40, 2, 32, 40, 1),
    # K1's tile edges: 128 query rows a block, 64 keys a tile
    (2, 129, 3, 32, 65, 64), (2, 129, 2, 16, 65, 65), (1, 129, 3, 64, 129, 64),
    (2, 129, 2, 64, 130, 65),
])
def test_ref_log_sum_exp_matches_float64(b, s, h, d, t, kv_valid):
    """lse = log2 Σⱼ exp2(s·log2 e) over the unmasked keys, s = q·k/√D: the
    log2 domain K1 writes it in, against numpy in float64."""
    q, k, v = rand_qkv(12, b, s, h, d, t)
    _, lse = fa.flash_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                                    kv_valid, return_lse=True)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    n = t if kv_valid is None else kv_valid
    s2 = np.einsum("bshd,bthd->bhst", q.astype(np.float64),
                   k[:, :n].astype(np.float64)) * d ** -0.5 * np.log2(np.e)
    top = s2.max(axis=-1, keepdims=True)
    want = (top + np.log2(np.exp2(s2 - top).sum(axis=-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-6)


def test_cpu_bwd_wrapper_takes_plain_version_with_lse():
    q, k, v = (torch.from_numpy(x).bfloat16() for x in rand_qkv(13, 2, 50, 2, 16, 70))
    g = torch.from_numpy(rand_g(14, 2, 50, 2, 16)).bfloat16()
    _, lse = fa.flash_attention_ref(q, k, v, 60, return_lse=True)
    before = fa.bwd_launch_count(), fa.launch_count()
    got = fa.flash_attention_bwd(q, k, v, g, 60, lse=lse)
    assert (fa.bwd_launch_count(), fa.launch_count()) == before
    for a, w in zip(got, fa.flash_attention_bwd_ref(q, k, v, g, 60, lse=lse)):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    assert (got[1][:, 60:] == 0).all() and (got[2][:, 60:] == 0).all()
    # p from the lse is e / Σe to f32 rounding: the bf16 results one ulp apart at most
    for a, w in zip(got, fa.flash_attention_bwd_ref(q, k, v, g, 60)):
        top = w.float().abs().max()
        assert (a.float() - w.float()).abs().max() <= 2 ** -7 * top


def test_plain_attention_grad_matches_xla_vjp():
    """The CPU model's gradient: autograd through `plain_attention` against
    jax.vjp of `xla_attention`, with kv_valid (f32, atol 2e-4 rtol 1e-3 as
    the kernel backward)."""
    from tunevlseg_tpu.nn.attention import xla_attention
    from tunevlseg_torch.nn.attention import plain_attention
    q, k, v = rand_qkv(10, 2, 70, 2, 32, 70)
    g = rand_g(11, 2, 70, 2, 32)
    _, vjp = jax.vjp(lambda a, b, c: xla_attention(a, b, c, kv_valid=60),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(g))
    qkv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(plain_attention(*qkv, kv_valid=60), qkv,
                              torch.from_numpy(g))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-4,
                                   rtol=1e-3)
    assert (got[1][:, 60:] == 0).all() and (got[2][:, 60:] == 0).all()


def test_reset_sets_both_launch_counts_to_zero():
    fa.reset_launch_count()
    assert fa.launch_count() == 0 and fa.bwd_launch_count() == 0


def test_k1_and_the_variants_run_the_hopper_forward_body():
    """K1 and the sweeps' S1 / S2 / S4 kernel are instances of one forward
    body (csrc/attn_fwd_hopper.cuh: wgmma on operands a producer warp brings
    in by TMA through an mbarrier ring), with no mma.sync path left beside
    it; the body's header is part of every library's build hash. Its TMA
    loads and its P V product go through attn_hopper.cuh's column-chunk
    helpers (one chunk at D <= 64, three of 32 at D = 96), which issue
    `tma_load_4d` and `wgmma_rs`."""
    from tunevlseg_torch.ops import build
    csrc = build.SOURCES["fwd"].parent
    body = (csrc / "attn_fwd_hopper.cuh").read_text()
    for needed in ("tma_load_rows<D>", "mbar_wait", "wgmma_m64n64k16",
                   "wgmma_rs_cols<D>"):
        assert needed in body, needed
    blocks = (csrc / "attn_hopper.cuh").read_text()
    for needed in ("tma_load_4d(dst + c * pitch", "wgmma_rs<C::kW, 1>"):
        assert needed in blocks, needed
    for source in (build.SOURCES["fwd"], build.SWEEP_SOURCES["variants"]):
        text = source.read_text()
        assert '#include "attn_fwd_hopper.cuh"' in text
        assert "attn_fwd_body<" in text
        assert "mma_bf16_16816" not in text and "load_tile" not in text
    assert csrc / "attn_fwd_hopper.cuh" in build.HEADERS
