"""The port's attention, layers, transposed conv, resize, loss and metrics
against the JAX package on the same numpy inputs (CPU, f32 unless noted)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402

from tunevlseg_tpu.nn import attention as jatt  # noqa: E402
from tunevlseg_tpu.nn import conv as jconv  # noqa: E402
from tunevlseg_tpu.nn import layers as jlayers  # noqa: E402
from tunevlseg_tpu.ops import image as jimage  # noqa: E402
from tunevlseg_tpu.ops import losses as jlosses  # noqa: E402
from tunevlseg_tpu.ops import metrics as jmetrics  # noqa: E402
from tunevlseg_torch.convert.from_jax import state_dict_from_jax  # noqa: E402
from tunevlseg_torch.nn import attention as tatt  # noqa: E402
from tunevlseg_torch.nn import conv as tconv  # noqa: E402
from tunevlseg_torch.nn import layers as tlayers  # noqa: E402
from tunevlseg_torch.ops import image as timage  # noqa: E402
from tunevlseg_torch.ops import losses as tlosses  # noqa: E402
from tunevlseg_torch.ops import metrics as tmetrics  # noqa: E402


def _rng(seed=0):
    return np.random.default_rng(seed)


def _causal_pad(b, s):
    mask = np.ones((b, s), np.int32)
    mask[1, s - 17:] = 0
    return mask


def test_bias_helpers_match_jax():
    mask = _causal_pad(2, 21)
    np.testing.assert_array_equal(tatt.causal_bias(21).numpy(),
                                  np.asarray(jatt.causal_bias(21)))
    np.testing.assert_array_equal(
        tatt.padding_bias(torch.from_numpy(mask)).numpy(),
        np.asarray(jatt.padding_bias(jnp.asarray(mask))))


# f32: the same algorithm, summation order differs -> 1e-5
@pytest.mark.parametrize("kv_valid", [None, 50])
def test_plain_attention_matches_xla_attention(kv_valid):
    rng = _rng(1)
    b, s, h, d = 2, 61, 2, 32
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3))
    mask = _causal_pad(b, s)
    jbias = jatt.causal_bias(s) + jatt.padding_bias(jnp.asarray(mask))
    tbias = tatt.causal_bias(s) + tatt.padding_bias(torch.from_numpy(mask))
    want = jatt.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jbias, kv_valid=kv_valid)
    got = tatt.plain_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), tbias, kv_valid=kv_valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_plain_attention_bf16_rounding_matches():
    """bf16: the scores are rounded to bf16 before the bias add on both
    sides; one bf16 ulp at |o| < 4 bounds the difference."""
    rng = _rng(2)
    b, s, h, d = 2, 33, 2, 16
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3))
    mask = _causal_pad(b, s)
    jb = lambda x: jnp.asarray(x).astype(jnp.bfloat16)
    tb = lambda x: torch.from_numpy(x).bfloat16()
    want = jatt.xla_attention(jb(q), jb(k), jb(v),
                              jatt.causal_bias(s) + jatt.padding_bias(jnp.asarray(mask)))
    got = tatt.plain_attention(tb(q), tb(k), tb(v),
                               tatt.causal_bias(s)
                               + tatt.padding_bias(torch.from_numpy(mask)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), atol=1.6e-2)


def test_gate_sends_cpu_tensors_to_plain_path():
    q = torch.zeros(1, 300, 2, 32, dtype=torch.bfloat16)
    assert not tatt._kernel_eligible(q, q, None)
    out = tatt.dot_product_attention(q, q, q)
    torch.testing.assert_close(out, tatt.plain_attention(q, q, q))


def _load(tmodule, jparams):
    tmodule.load_state_dict(state_dict_from_jax(jparams, tmodule))
    return tmodule


@pytest.mark.parametrize("kind", ["pre", "post"])
def test_encoder_layers_match_jax(kind):
    rng = _rng(3)
    b, s, dim, heads, inter = 2, 19, 32, 4, 48
    x = rng.normal(size=(b, s, dim)).astype(np.float32)
    mask = _causal_pad(b, s)
    jbias = jatt.causal_bias(s) + jatt.padding_bias(jnp.asarray(mask))
    tbias = tatt.causal_bias(s) + tatt.padding_bias(torch.from_numpy(mask))
    if kind == "pre":
        jm = jlayers.PreNormEncoderLayer(heads, inter)
        tm = tlayers.PreNormEncoderLayer(dim, heads, inter)
    else:
        jm = jlayers.PostNormEncoderLayer(heads, inter, act="relu")
        tm = tlayers.PostNormEncoderLayer(dim, heads, inter, act="relu")
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jbias)["params"]
    want = jm.apply({"params": params}, jnp.asarray(x), jbias)
    with torch.no_grad():
        got = _load(tm, params)(torch.from_numpy(x), tbias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_activations_match_jax():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    for name, fn in tlayers.ACT2FN.items():
        np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(),
                                   np.asarray(jlayers.ACT2FN[name](jnp.asarray(x))),
                                   atol=1e-6, rtol=1e-6, err_msg=name)


def test_conv_transpose_patch_matches_jax():
    rng = _rng(4)
    x = rng.normal(size=(2, 8, 3, 3)).astype(np.float32)
    w = rng.normal(size=(8, 1, 16, 16)).astype(np.float32)
    bias = rng.normal(size=(1,)).astype(np.float32)
    want = jconv.conv_transpose_patch(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(bias), 16)
    got = tconv.conv_transpose_patch(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(bias))
    assert got.shape == (2, 1, 48, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # the same function as torch's own transposed conv
    np.testing.assert_allclose(
        got.numpy(),
        torch.nn.functional.conv_transpose2d(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
            stride=16).numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("grid", [(2, 4), (14, 22)])
def test_bicubic_resize_matches_jax(grid):
    src, dst = grid
    img = _rng(5).normal(size=(6, src, src)).astype(np.float32)
    want = jimage.resize_2d(jnp.asarray(img), (dst, dst), "bicubic")
    got = timage.resize_2d(torch.from_numpy(img), (dst, dst), "bicubic")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_dice_ce_loss_and_metrics_match_jax():
    rng = _rng(6)
    logits = (3 * rng.normal(size=(4, 1, 16, 16))).astype(np.float32)
    mask = (rng.random((4, 1, 16, 16)) > 0.6).astype(np.float32)
    mask[2] = 0.0   # an empty target: dice zero_division
    valid = np.array([1, 1, 1, 0], np.float32)
    # the loss options the configurations set: coop/e2e defaults,
    # trans_seg lambda_ce=1, phrasecut weight=5.8
    for kw in ({}, {"lambda_ce": 1.0}, {"weight": 5.8}):
        np.testing.assert_allclose(
            tlosses.dice_ce_loss(torch.from_numpy(logits),
                                 torch.from_numpy(mask), **kw).item(),
            float(jlosses.dice_ce_loss(jnp.asarray(logits), jnp.asarray(mask),
                                       **kw)),
            rtol=1e-6, atol=1e-6, err_msg=str(kw))
    probs = 1 / (1 + np.exp(-logits))
    js = jmetrics.update_state(jmetrics.SegMetricState.zeros(), jnp.asarray(probs),
                               jnp.asarray(mask), valid=jnp.asarray(valid))
    ts = tmetrics.update_state(tmetrics.SegMetricState.zeros(),
                               torch.from_numpy(probs), torch.from_numpy(mask),
                               valid=torch.from_numpy(valid))
    ts = ts.merge(tmetrics.SegMetricState.zeros())
    np.testing.assert_allclose([float(x) for x in ts], [float(x) for x in js],
                               rtol=1e-6)
    jc, tc = jmetrics.compute(js), tmetrics.compute(ts)
    for key in ("dice", "iou"):
        np.testing.assert_allclose(tc[key].item(), float(jc[key]), rtol=1e-6)
