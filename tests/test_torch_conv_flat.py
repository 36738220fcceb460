"""The port's flat guard-banded convolution (`tunevlseg_torch/ops/conv_flat.py`)
against the JAX package's (`tunevlseg_tpu/ops/conv_pallas.py`) on the CPU,
where the port runs K4's plain version and the JAX package its Pallas kernel
in interpret mode (as tests/test_conv_pallas.py runs it). Inputs come from a
numpy seed and go through both: the geometry, `flat_begin` / `flat_end`
element by element, the convolution over kernel size, channel counts, ReLU,
affine and residual, a bottleneck-shaped chain, and all five gradients of
the analytic backward against `jax.grad`."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import tunevlseg_tpu.ops.conv_pallas as cp  # noqa: E402
from tunevlseg_torch.ops import conv_flat as tc  # noqa: E402

# f32 on the CPU in both packages: the same products, summed in another order
# (the tolerance of tests/test_conv_pallas.py)
F32_TOL = 2e-5
# bf16: inputs and weight are the same bf16 values on both sides and both
# accumulate in f32, so the outputs differ by the last rounding to bf16 of
# sums that differ in their last f32 bits: one bf16 ulp (2^-8 relative) of
# outputs of magnitude up to ~4
BF16_TOL = 4 * 2 ** -8


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(cp, "_INTERPRET", True)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


SWEEP = [(h, w, c, it)
         for h, w in [(13, 13), (26, 26), (52, 52), (104, 104), (208, 208),
                      (41, 41), (118, 118), (206, 206), (354, 354), (256, 256)]
         for c, it in [(32, 2), (64, 2), (128, 2), (256, 2), (512, 2), (64, 4)]]


@pytest.mark.parametrize("h,w,c,itemsize", SWEEP)
def test_make_flat_spec_equals_jax(h, w, c, itemsize):
    want = cp.make_flat_spec(h, w, 1, max_k2c=9 * c, itemsize=itemsize)
    got = tc.make_flat_spec(h, w, 1, max_k2c=9 * c, itemsize=itemsize)
    for name in ("h", "w", "r", "mb", "qb", "hp", "wp", "mp", "lead", "nb_pix",
                 "rows"):
        assert getattr(got, name) == getattr(want, name), name
    assert tc._tap_offsets(got, 3) == cp._tap_offsets(want, 3)
    # what the kernel's shifted reads rely on
    assert got.lead <= got.qb <= got.mb
    assert got.mb + got.mp + got.lead <= got.rows


def test_spec_defaults_explicit_band_and_rejection():
    assert tc.make_flat_spec(9, 11, 2, mb=64) == tc.FlatSpec(9, 11, 2, 64, 32)
    for kw in (dict(h=10, w=12, r=1), dict(h=6, w=6, r=2, mb=64),
               dict(h=30, w=30, r=1, max_k2c=1 << 16, itemsize=4)):
        want, got = cp.make_flat_spec(**kw), tc.make_flat_spec(**kw)
        assert (got.mb, got.qb, got.rows) == (want.mb, want.qb, want.rows)
    with pytest.raises(ValueError, match="lead"):
        tc.make_flat_spec(64, 64, 1, mb=8)


@pytest.mark.parametrize("r", [1, 2])
def test_flat_begin_and_end_match_jax(r):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 9, 5)).astype(np.float32)
    jspec, tspec = cp.make_flat_spec(7, 9, r, mb=64), tc.make_flat_spec(7, 9, r, mb=64)
    want = np.asarray(cp.flat_begin(jnp.asarray(x), jspec))
    got = tc.flat_begin(torch.from_numpy(x), tspec)
    assert got.shape == want.shape == (2, tspec.rows, 5)
    np.testing.assert_array_equal(got.numpy(), want)
    # the valid-row mask is where flat_begin put the pixels
    valid = tc._valid_rows(tspec).numpy()
    np.testing.assert_array_equal(valid, np.asarray(cp._valid_rows(jspec)) > 0)
    assert valid.sum() == 7 * 9 and bool((got.numpy()[:, ~valid] == 0).all())
    back = tc.flat_end(got, tspec)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(cp.flat_end(jnp.asarray(want), jspec)))
    # flat_end is a view of the flat tensor; flat_begin reads a channels-last
    # NCHW tensor's NHWC view in place
    assert back.untyped_storage().data_ptr() == got.untyped_storage().data_ptr()
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    assert nchw.permute(0, 2, 3, 1).is_contiguous()
    assert torch.equal(tc.flat_begin(nchw.permute(0, 2, 3, 1), tspec), got)


def _case(seed, cin, cout, k, hw, affine, res, b=2):
    rng = np.random.RandomState(seed)
    h, w = hw
    x = rng.randn(b, h, w, cin).astype(np.float32)
    wt = (rng.randn(cout, cin, k, k) * 0.1).astype(np.float32)
    sc = (rng.rand(cout) + 0.5).astype(np.float32) if affine else None
    of = (rng.randn(cout) * 0.1).astype(np.float32) if affine else None
    rs = rng.randn(b, h, w, cout).astype(np.float32) if res else None
    return x, wt, sc, of, rs


def _jax_conv(spec, x, wt, sc, of, relu, rs, dtype=jnp.float32):
    """The JAX `conv_flat` on NHWC numpy inputs; returns the flat output."""
    conv = lambda a: None if a is None else jnp.asarray(a)
    residual = None if rs is None else cp.flat_begin(jnp.asarray(rs, dtype), spec)
    return cp.conv_flat(cp.flat_begin(jnp.asarray(x, dtype), spec), spec,
                        jnp.asarray(wt), conv(sc), conv(of), relu, residual)


def _torch_conv(spec, x, wt, sc, of, relu, rs, dtype=torch.float32):
    conv = lambda a: None if a is None else _t(a)
    residual = None if rs is None else tc.flat_begin(_t(rs, dtype), spec)
    return tc.conv_flat(tc.flat_begin(_t(x, dtype), spec), spec, _t(wt),
                        conv(sc), conv(of), relu, residual)


CASES = [
    # cin, cout, k, hw, relu, affine, residual
    (8, 16, 3, (10, 12), True, True, False),
    (16, 8, 1, (10, 12), False, True, False),
    (8, 8, 3, (7, 9), True, False, True),
    (4, 4, 5, (6, 6), False, True, False),
    (128, 32, 3, (8, 8), True, True, False),    # the TPU kernel's taps mode
    (8, 24, 1, (7, 9), True, True, True),       # 1x1 widening with residual
    (16, 8, 3, (9, 11), False, False, False),   # no affine, no ReLU
    (8, 16, 3, (5, 13), True, True, True),
]


@pytest.mark.parametrize("cin,cout,k,hw,relu,affine,res", CASES)
def test_conv_flat_matches_jax_f32(cin, cout, k, hw, relu, affine, res):
    x, wt, sc, of, rs = _case(0, cin, cout, k, hw, affine, res)
    r = max(k // 2, 1)
    jspec = cp.make_flat_spec(*hw, r, mb=64)
    tspec = tc.make_flat_spec(*hw, r, mb=64)
    want = np.asarray(_jax_conv(jspec, x, wt, sc, of, relu, rs))
    got = _torch_conv(tspec, x, wt, sc, of, relu, rs)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL)
    # guard and ring rows are exactly zero
    assert bool((got[:, ~tc._valid_rows(tspec)] == 0).all())
    # the one-off wrapper, NHWC and NCHW, against the flat chain
    conv = lambda a: None if a is None else _t(a)
    if not res:
        one = tc.conv2d_same_flat(_t(x), _t(wt), conv(sc), conv(of), relu, spec=tspec)
        assert torch.equal(one, tc.flat_end(got, tspec))
        nchw = tc.conv2d_same_flat(_t(x).permute(0, 3, 1, 2), _t(wt), conv(sc),
                                   conv(of), relu, layout="nchw")
        want_one = cp.conv2d_same_pallas(jnp.asarray(x), jnp.asarray(wt),
                                         None if sc is None else jnp.asarray(sc),
                                         None if of is None else jnp.asarray(of), relu)
        np.testing.assert_allclose(nchw.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want_one), atol=F32_TOL)


@pytest.mark.parametrize("cin,cout,k,hw,relu,affine,res", CASES[:3] + CASES[5:6])
def test_conv_flat_matches_jax_bf16(cin, cout, k, hw, relu, affine, res):
    x, wt, sc, of, rs = _case(3, cin, cout, k, hw, affine, res)
    r = max(k // 2, 1)
    jspec = cp.make_flat_spec(*hw, r, mb=64)
    tspec = tc.make_flat_spec(*hw, r, mb=64)
    want = _jax_conv(jspec, x, wt, sc, of, relu, rs, jnp.bfloat16)
    got = _torch_conv(tspec, x, wt, sc, of, relu, rs, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    diff = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
    assert diff.max() <= BF16_TOL, diff.max()
    assert bool((got[:, ~tc._valid_rows(tspec)] == 0).all())


def test_chained_stage_in_flat_space_matches_jax():
    """1x1 -> 3x3 -> 1x1 + residual with fused affines and ReLUs: the guard
    bands and the masked ring that convolution N writes are what N + 1 reads."""
    rng = np.random.RandomState(1)
    h, w, c, mid = 9, 11, 16, 8
    x = rng.randn(2, h, w, c).astype(np.float32)
    ws = [(rng.randn(*s) * 0.2).astype(np.float32)
          for s in ((mid, c, 1, 1), (mid, mid, 3, 3), (c, mid, 1, 1))]
    sc = [(rng.rand(n) + 0.5).astype(np.float32) for n in (mid, mid, c)]
    of = [(rng.randn(n) * 0.1).astype(np.float32) for n in (mid, mid, c)]

    def chain(lib, spec, conv):
        f = lib.flat_begin(conv(x), spec)
        y = lib.conv_flat(f, spec, conv(ws[0]), conv(sc[0]), conv(of[0]), relu=True)
        y = lib.conv_flat(y, spec, conv(ws[1]), conv(sc[1]), conv(of[1]), relu=True)
        y = lib.conv_flat(y, spec, conv(ws[2]), conv(sc[2]), conv(of[2]), relu=True,
                          residual=f)
        return y, lib.flat_end(y, spec)

    jflat, jout = chain(cp, cp.make_flat_spec(h, w, 1, mb=64), jnp.asarray)
    tflat, tout = chain(tc, tc.make_flat_spec(h, w, 1, mb=64), _t)
    np.testing.assert_allclose(tflat.numpy(), np.asarray(jflat), atol=F32_TOL)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=F32_TOL)
    # and against the plain convolutions of PyTorch
    F = torch.nn.functional
    r = _t(x).permute(0, 3, 1, 2)
    aff = lambda y, i: y * _t(sc[i])[None, :, None, None] + _t(of[i])[None, :, None, None]
    y = F.relu(aff(F.conv2d(r, _t(ws[0])), 0))
    y = F.relu(aff(F.conv2d(y, _t(ws[1]), padding=1), 1))
    y = F.relu(aff(F.conv2d(y, _t(ws[2])), 2) + r)
    np.testing.assert_allclose(tout.permute(0, 3, 1, 2).numpy(), y.numpy(),
                               atol=F32_TOL)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("relu,res", [(True, False), (False, True), (True, True)])
def test_all_five_gradients_match_jax_grad(relu, res, k):
    """dx, dW, d_scale, d_offset and d_residual of the port's analytic
    backward against `jax.grad` of the JAX `conv_flat` (its custom_vjp, dx
    through the Pallas kernel in interpret mode), f32 at 5e-5 (the tolerance
    of tests/test_conv_pallas.py). Channel 0's scale is exactly 0: d_scale
    still matches. dx is exactly zero on guard and ring rows."""
    rng = np.random.RandomState(2)
    h, w, c, o = 8, 7, 8, 16
    x = rng.randn(2, h, w, c).astype(np.float32)
    wt = (rng.randn(o, c, k, k) * 0.1).astype(np.float32)
    sc = (rng.rand(o) + 0.5).astype(np.float32)
    sc[0] = 0.0
    of = (rng.randn(o) * 0.1).astype(np.float32)
    rs = rng.randn(2, h, w, o).astype(np.float32)
    cot = rng.randn(2, h, w, o).astype(np.float32)   # the output's cotangent
    jspec = cp.make_flat_spec(h, w, 1, mb=64)
    tspec = tc.make_flat_spec(h, w, 1, mb=64)

    def jloss(x, wt, sc, of, rs):
        y = cp.conv_flat(cp.flat_begin(x, jspec), jspec, wt, sc, of, relu,
                         cp.flat_begin(rs, jspec) if res else None)
        return jnp.sum(cp.flat_end(y, jspec) * jnp.asarray(cot))

    n = 5 if res else 4
    want = jax.grad(jloss, tuple(range(n)))(*map(jnp.asarray, (x, wt, sc, of, rs)))
    args = [_t(a).requires_grad_() for a in (x, wt, sc, of, rs)]
    flat_x = tc.flat_begin(args[0], tspec)
    flat_x.retain_grad()
    y = tc.conv_flat(flat_x, tspec, args[1], args[2], args[3], relu,
                     tc.flat_begin(args[4], tspec) if res else None)
    (tc.flat_end(y, tspec) * _t(cot)).sum().backward()
    for name, a, b in zip(("dx", "dw", "d_scale", "d_offset", "d_residual"),
                          args[:n], want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=5e-5,
                                   err_msg=name)
    assert bool((flat_x.grad[:, ~tc._valid_rows(tspec)] == 0).all())
    assert float(flat_x.grad.abs().max()) > 0


def test_backward_computes_only_what_is_asked_and_saves_nothing_when_frozen():
    rng = np.random.RandomState(4)
    spec = tc.make_flat_spec(6, 6, 1, mb=64)
    x = tc.flat_begin(_t(rng.randn(1, 6, 6, 8)), spec)
    wt = _t(rng.randn(8, 8, 3, 3) * 0.1)
    saved = []
    hooks = torch.autograd.graph.saved_tensors_hooks(
        lambda t: saved.append(tuple(t.shape)) or t, lambda t: t)
    with hooks:
        out = tc.conv_flat(x, spec, wt, relu=True)
    assert not out.requires_grad and saved == []
    # only the weight wants a gradient: no dx product, a dW
    wt.requires_grad_()
    calls = []
    ref = tc.conv_flat_ref
    try:
        tc.conv_flat_ref = lambda *a: calls.append(a) or ref(*a)
        out = tc.conv_flat(x, spec, wt, relu=True)
        out.sum().backward()
    finally:
        tc.conv_flat_ref = ref
    assert len(calls) == 1 and wt.grad is not None
    assert tc.launch_count() == tc.dx_launch_count() == tc.dy_launch_count() == 0


def test_dispatch_is_by_device_and_dtype():
    """A CPU tensor takes the plain version, in f32 and in bf16; a bf16 CUDA
    tensor would launch K4 (tests/test_torch_gpu.py, on the card)."""
    spec = tc.make_flat_spec(6, 6, 1, mb=64)
    x = tc.flat_begin(_t(np.ones((1, 6, 6, 8))), spec)
    wt = _t(np.ones((8, 8, 1, 1)))
    for dtype in (torch.float32, torch.bfloat16):
        out = tc.conv_flat(x.to(dtype), spec, wt)
        assert out.dtype == dtype
        assert torch.equal(tc.flat_end(out, spec).float(), torch.full((1, 6, 6, 8), 8.0))
    with pytest.raises(AssertionError):
        tc.conv_flat(x, spec, _t(np.ones((8, 8, 2, 2))))       # even kernel
    with pytest.raises(AssertionError):
        tc.conv_flat(x, spec, _t(np.ones((8, 8, 5, 5))))       # k // 2 > r


def test_bf16_weight_offset_and_residual_gradients_match_jax_grad():
    """The backward's glue in bf16, as the card runs it: the prologue's plain
    version (dy masked by the ReLU state, dy * scale and dy in bf16, the f32
    sum of dy), dW as one product per tap over the whole batch, against
    `jax.grad` of the JAX `conv_flat` on the same bf16 inputs. dy is exact in
    bf16 (a bf16 cotangent times 0 or 1), so dW, d_scale and d_offset differ
    from JAX's f32 contraction by f32 summation order alone (1e-5 of the
    largest entry); d_residual is the same bf16 dy; dx goes through one more
    bf16 rounding of dy * scale on both sides and the two kernels' plain
    versions, one bf16 ulp of the largest entry (BF16_TOL)."""
    rng = np.random.RandomState(7)
    h, w, c, o, k = 9, 8, 16, 24, 3
    x = rng.randn(3, h, w, c).astype(np.float32)
    wt = (rng.randn(o, c, k, k) * 0.1).astype(np.float32)
    sc = (rng.rand(o) + 0.5).astype(np.float32)
    sc[1] = 0.0
    of = (rng.randn(o) * 0.1).astype(np.float32)
    rs = rng.randn(3, h, w, o).astype(np.float32)
    cot = rng.randn(3, h, w, o).astype(np.float32)
    jspec = cp.make_flat_spec(h, w, 1, mb=64)
    tspec = tc.make_flat_spec(h, w, 1, mb=64)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)

    def jloss(x, wt, sc, of, rs):
        y = cp.conv_flat(cp.flat_begin(x, jspec), jspec, wt, sc, of, True,
                         cp.flat_begin(rs, jspec))
        return jnp.sum(cp.flat_end(y, jspec).astype(jnp.float32)
                       * bf(cot).astype(jnp.float32))

    want = jax.grad(jloss, tuple(range(5)))(bf(x), jnp.asarray(wt), jnp.asarray(sc),
                                           jnp.asarray(of), bf(rs))
    args = [_t(x, torch.bfloat16), _t(wt), _t(sc), _t(of), _t(rs, torch.bfloat16)]
    args = [a.requires_grad_() for a in args]
    y = tc.conv_flat(tc.flat_begin(args[0], tspec), tspec, args[1], args[2],
                     args[3], True, tc.flat_begin(args[4], tspec))
    (tc.flat_end(y, tspec).float() * _t(cot, torch.bfloat16).float()).sum().backward()
    for name, a, b in zip(("dx", "dw", "d_scale", "d_offset", "d_residual"),
                          args, want):
        got = a.grad.float().numpy()
        ref = np.asarray(jnp.asarray(b, jnp.float32))
        top = np.abs(ref).max()
        tol = BF16_TOL if name == "dx" else 1e-5
        assert np.abs(got - ref).max() <= tol * top, (name, np.abs(got - ref).max(), top)


@pytest.mark.parametrize("k", [1, 3])
def test_weight_gradient_products_over_the_whole_batch_are_exact(k):
    """`weight_grad_taps` contracts each tap over every (batch, row) pair of
    the flat tensors at once; with dy zero outside the pixel blocks that is
    the per-image sum over each image's pixel block, in f64 to the bit of
    the f64 sums' rounding."""
    rng = np.random.RandomState(8)
    spec = tc.make_flat_spec(7, 6, 1, mb=64)
    x = tc.flat_begin(torch.from_numpy(rng.randn(3, 7, 6, 8)), spec)
    valid = tc._valid_rows(spec)[None, :, None]
    dy = torch.from_numpy(rng.randn(3, spec.rows, 16)) * valid
    got = tc.weight_grad_taps(spec, k, x, dy)
    lo, hi = spec.mb, spec.mb + spec.mp
    want = torch.cat([sum(x[i, lo + off:hi + off].t() @ dy[i, lo:hi] for i in range(3))
                      for off in tc._tap_offsets(spec, k)])
    assert got.shape == (k * k * 8, 16)
    np.testing.assert_allclose(got.numpy(), want.float().numpy(), rtol=1e-6, atol=1e-5)
