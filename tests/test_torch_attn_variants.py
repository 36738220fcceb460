"""The plain versions of the K1 variants S1-S4
(`tunevlseg_torch/ops/flash_attention_variants.py`) against the JAX sweep
scripts' own yardsticks on the CPU: `xla_attn` of `scripts/micro_attn_v2.py`
and `tunevlseg_tpu.nn.attention.xla_attention` (what `micro_attn.py` and
`micro_attn_grid.py` hold their kernels against), and the Pallas kernels
`batched_heads` (S2) and `batched_heads_opt` (S3) themselves, run in
interpret mode (the test wraps `pl.pallas_call` for the call; nothing in the
scripts changes). S1 and S4 are closures inside their scripts' `main()` and
compute K1's function, so they are held against the yardstick alone.

Tolerances. bf16 inputs and outputs of order 1: against the Pallas kernel,
which rounds p and the output where the plain version does, 1e-2 (one bf16
ulp at 1 is 7.8e-3; the scale enters the scores before the product in S3 and
after it in S2, and exp2 against exp moves the last f32 bits); against the
XLA yardstick, which rounds the scores to bf16 before the softmax, 2e-2, the
bound the scripts assert themselves."""
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from tunevlseg_tpu.nn.attention import xla_attention  # noqa: E402
from tunevlseg_torch.ops import flash_attention as fa  # noqa: E402
from tunevlseg_torch.ops import flash_attention_variants as fav  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_TOL = 1e-2
YARDSTICK_TOL = 2e-2


@pytest.fixture(scope="module")
def v2():
    spec = importlib.util.spec_from_file_location(
        "micro_attn_v2", os.path.join(REPO, "scripts", "micro_attn_v2.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def interpret_mode(monkeypatch):
    """Run the scripts' `pl.pallas_call`s on the CPU, as the JAX package's
    tests run its kernels."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _qkv(seed, b=2, s=128, h=4, d=64, scale=1.0):
    rng = np.random.default_rng(seed)
    return tuple((scale * rng.normal(size=(b, s, h, d))).astype(np.float32)
                 for _ in range(3))


def _pair(arrays):
    """The same bf16 values for both frameworks."""
    t = [torch.from_numpy(a).bfloat16() for a in arrays]
    j = [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in t]
    return t, j


def _err(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got.float().numpy() - want).max())


S2_CASES = {
    "ours": {},
    "exp2": dict(use_exp2=True),
    "nomax": dict(skip_max=True),
    "exp2+nomax": dict(use_exp2=True, skip_max=True),
    "hg2": dict(force_hg=2),
    "hg4-arbitrary": dict(force_hg=4, arbitrary=True),
}


# (S, T, kv_valid) at b2 h4 (the hg4 case takes four heads): 128 x 128 with
# and without masked keys, then the tile edges the kernel masks (128 query
# rows a block, 64 keys a tile)
S2_GEOMETRIES = [
    pytest.param((128, 128, None), id="None"), pytest.param((128, 128, 100), id="100"),
    pytest.param((128, 128, 64), id="s128-kv64"), pytest.param((128, 128, 65), id="s128-kv65"),
    pytest.param((129, 65, None), id="s129-t65"), pytest.param((129, 65, 64), id="s129-t65-kv64"),
]


@pytest.mark.parametrize("geometry", S2_GEOMETRIES)
@pytest.mark.parametrize("case", list(S2_CASES))
def test_variant_plain_version_matches_the_pallas_kernel(v2, interpret_mode, case,
                                                         geometry):
    """S2: every softmax switch of `batched_heads`. Its `force_hg` and grid
    semantics change the TPU grid, not the value: the plain version ignores
    `hg` and `block_order` likewise."""
    kw = dict(S2_CASES[case])
    s, t, kv_valid = geometry
    q = _qkv(0, s=s)[0]
    k, v = _qkv(1, s=t)[1:]
    (q, k, v), (jq, jk, jv) = _pair((q, k, v))
    want = v2.batched_heads(jq, jk, jv, kv_valid=kv_valid, **kw)
    hg = kw.pop("force_hg", 1)
    order = "head" if kw.pop("arbitrary", False) else "query"
    got = fav.attention_variant_ref(q, k, v, kv_valid, hg=hg, block_order=order, **kw)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert _err(got, want) <= KERNEL_TOL
    # and through the wrapper, which takes the plain version for CPU tensors
    routed = fav.attention_variant(q, k, v, kv_valid, hg=hg, block_order=order, **kw)
    assert torch.equal(routed, got)


@pytest.mark.parametrize("hg", [1, 2])
def test_gemm_only_plain_version_matches_the_pallas_kernel(v2, interpret_mode, hg):
    """(q kᵀ · scale) v over all keys: no softmax, no mask, outputs of order
    10, so the bound is 1e-2 of the largest |reference| (bf16 ulp 3.9e-3)."""
    (q, k, v), (jq, jk, jv) = _pair(_qkv(1))
    want = v2.batched_heads(jq, jk, jv, gemm_only=True, force_hg=hg)
    got = fav.attention_variant(q, k, v, gemm_only=True, hg=hg)
    top = float(np.abs(np.asarray(jnp.asarray(want, jnp.float32))).max())
    assert top > 5 and _err(got, want) <= KERNEL_TOL * top
    plain = torch.einsum("bhst,bthd->bshd", torch.einsum(
        "bshd,bthd->bhst", q.float(), k.float()) * 0.125, v.float())
    assert (got.float() - plain).abs().max().item() <= 2e-2 * top
    with pytest.raises(ValueError, match="no softmax"):
        fav.attention_variant(q, k, v, gemm_only=True, use_exp2=True)


@pytest.mark.parametrize("skip_max", [False, True])
@pytest.mark.parametrize("seq,kv_valid", [(128, None), (128, 100), (100, None)])
def test_ones_column_plain_version_matches_the_pallas_kernel(v2, interpret_mode,
                                                             seq, kv_valid,
                                                             skip_max):
    """S3: scale folded into q in bf16, additive f32 mask row, exp2, the
    denominator as the last column of p @ [v | 1] (the sum of the ROUNDED
    p). seq = 100 has a ragged key tail that only the mask row hides."""
    (q, k, v), (jq, jk, jv) = _pair(_qkv(2, s=seq))
    want = v2.batched_heads_opt(jq, jk, jv, kv_valid=kv_valid, skip_max=skip_max)
    got = fav.attention_ones_column_ref(q, k, v, kv_valid, skip_max=skip_max)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert _err(got, want) <= KERNEL_TOL
    assert torch.equal(fav.attention_ones_column(q, k, v, kv_valid,
                                                 skip_max=skip_max, hg=2), got)


def test_ones_column_helpers():
    q = torch.randn(1, 3, 2, 64).bfloat16()
    factor = torch.tensor(0.125 * fav.LOG2E, dtype=torch.bfloat16)
    assert torch.equal(fav.fold_scale(q), q * factor)
    assert fav.mask_row(128, 128, "cpu") is None
    row = fav.mask_row(100, 90, "cpu")
    assert row.shape == (128,) and row.dtype == torch.float32
    assert not row[:90].any() and bool((row[90:] == fav.MASKED).all())
    assert fav.mask_row(100, 100, "cpu").shape == (128,)   # the ragged tail alone


@pytest.mark.parametrize("t", [1, 63, 64, 65, 485, 512])
def test_mask_row_pads_to_the_kernels_key_tile(t):
    """S3's kernel streams keys in tiles of KEY_TILE and reads the mask row
    over whole tiles: the row covers the ragged tail (zero-filled keys score 0)
    and the keys past kv_valid."""
    padded = -(-t // fav.KEY_TILE) * fav.KEY_TILE
    for t_valid in sorted({1, max(1, t - 1), t}):
        row = fav.mask_row(t, t_valid, "cpu")
        if t_valid == padded:
            assert row is None
            continue
        assert row.shape == (padded,)
        assert not row[:t_valid].any() and bool((row[t_valid:] == fav.MASKED).all())


VARIANTS = {
    "hg2 (S1)": (fav.attention_variant_ref, dict(hg=2)),
    "hg6 (S1)": (fav.attention_variant_ref, dict(hg=6)),
    "exp2 (S2)": (fav.attention_variant_ref, dict(use_exp2=True)),
    "nomax (S2)": (fav.attention_variant_ref, dict(skip_max=True)),
    "exp2+nomax (S2)": (fav.attention_variant_ref, dict(use_exp2=True,
                                                       skip_max=True)),
    "opt (S3)": (fav.attention_ones_column_ref, {}),
    "opt-nomax (S3)": (fav.attention_ones_column_ref, dict(skip_max=True)),
    "bg2 hg3 head (S4)": (fav.attention_variant_ref,
                          dict(bg=2, hg=3, block_order="head")),
}


@pytest.mark.parametrize("case", list(VARIANTS))
def test_softmax_variants_match_the_scripts_yardsticks(v2, case):
    """Every softmax variant computes K1's function: against `xla_attn`
    (micro_attn_v2.py) on q, k, v apart and against `xla_attention` on
    q = k = v scaled by 0.05, the inputs of micro_attn.py and
    micro_attn_grid.py, at the bound the scripts assert (2e-2)."""
    plain, kw = VARIANTS[case]
    (q, k, v), (jq, jk, jv) = _pair(_qkv(3, h=6))
    assert _err(plain(q, k, v, **kw), v2.xla_attn(jq, jk, jv)) <= YARDSTICK_TOL
    (x,), (jx,) = _pair(_qkv(4, h=6, scale=0.05)[:1])
    assert _err(plain(x, x, x, **kw), xla_attention(jx, jx, jx)) <= YARDSTICK_TOL
    # and K1's own plain version, to a bf16 ulp or two
    assert (plain(q, k, v, 100, **kw).float()
            - fa.flash_attention_ref(q, k, v, 100).float()).abs().max() <= 1.6e-2


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    q = torch.randn(4, 16, 6, 64).bfloat16()
    for fn in (fav.attention_variant, fav.attention_ones_column):
        with pytest.raises(ValueError, match="hg=4"):
            fn(q, q, q, hg=4)
        with pytest.raises(ValueError, match="bg=3"):
            fn(q, q, q, bg=3)
        with pytest.raises(ValueError, match="block_order"):
            fn(q, q, q, block_order="batch")
        with pytest.raises(ValueError, match="head dim 64"):
            fn(q[..., :32], q[..., :32], q[..., :32])
    assert fav.launch_count("variant") == fav.launch_count("ones_column") == 0
