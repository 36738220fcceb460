"""N1, the one-pass LayerNorm (`ops/layer_norm.py`, `csrc/layer_norm.cu`).

On the CPU: the rule `LayerNorm.forward` takes N1 by, and that every call
the rule turns away runs the plain chain, counted. On the card (`gpu`,
skipped elsewhere; this file imports no JAX): N1 against the chain it
replaces, forward and backward, at the port's widths, the backward's
determinism, a CUDA-graph capture, and the counters.

    python -m pytest --noconftest -m gpu tests/test_torch_layer_norm.py
"""
import pytest
import torch
import torch.nn.functional as F

from tunevlseg_torch.nn.layers import LayerNorm, init_params
from tunevlseg_torch.ops import layer_norm as n1
from tunevlseg_torch.ops import library

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
CPU, CUDA = torch.device("cpu"), torch.device("cuda")
EPS = 1e-5


# --- the gate, on the CPU -------------------------------------------------------

# (normalized shape, x dtype, output dtype, device, takes N1)
GATE = [
    ((768,), BF16, BF16, CUDA, True),        # the ViT's blocks
    ((64,), BF16, BF16, CUDA, True),         # CLIPSeg's decoder
    ((n1.MAX_D,), BF16, BF16, CUDA, True),   # the widest row
    ((768,), F32, F32, CUDA, False),         # all f32: one kernel already
    ((768,), BF16, BF16, CPU, False),        # the CPU, the JAX parity tests
    ((64, 11, 11), BF16, BF16, CUDA, False),  # trans_seg's per-sample (C, H, W)
    ((100,), BF16, BF16, CUDA, False),       # D % 8 != 0
    ((n1.MAX_D + 8,), BF16, BF16, CUDA, False),
    ((768,), torch.float64, BF16, CUDA, False),
    ((512,), BF16, F32, CUDA, False),        # a float32 side: run by no model
    ((512,), F32, BF16, CUDA, False),
    ((768,), F16, F16, CUDA, False),         # float16: run by no model
]


def test_the_gate_takes_the_last_axis_of_16_bit_cuda_calls_alone():
    got = [n1.engages(shape, dtype, out, device)
           for shape, dtype, out, device, _ in GATE]
    assert got == [want for *_, want in GATE]


@pytest.mark.parametrize("dim,x_dtype,dtype", [
    (16, BF16, BF16), (16, F32, F32), ((4, 3, 3), BF16, BF16)],
    ids=["bf16", "f32", "chw"])
def test_calls_the_gate_turns_away_run_the_plain_chain_counted(dim, x_dtype, dtype):
    ln = LayerNorm(dim, dtype=dtype)
    init_params(ln, torch.Generator().manual_seed(0))
    with torch.no_grad():
        ln.weight.add_(torch.randn(ln.weight.shape, generator=torch.Generator().manual_seed(1)))
    shape = (2, 5, dim) if isinstance(dim, int) else (2, *dim)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(2)).to(x_dtype)
    n1.reset_launch_count()
    y = ln(x)
    want = F.layer_norm(x.float(), ln.weight.shape, ln.weight, ln.bias, ln.eps)
    assert y.dtype == dtype and torch.equal(y, want.to(dtype))
    assert (n1.plain_count(), n1.launch_count(), n1.bwd_launch_count()) == (1, 0, 0)


def test_a_traced_call_takes_the_op_and_an_eager_one_the_launcher(monkeypatch):
    """On fake tensors (a `torch.export` trace) the forward goes through
    `tunevlseg::layer_norm`, whose fake implementation answers; on a plain
    tensor it goes to the launcher without the dispatcher."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    launched = []
    monkeypatch.setattr(n1, "_launch_fwd", lambda *a: launched.append(a) or ("eager",))
    with FakeTensorMode():
        x = torch.empty(2, 485, 768, dtype=BF16)
        y, mean, rstd = n1._forward(x, torch.empty(768), None, EPS, BF16)
    assert launched == [] and (y.shape, y.dtype, mean.shape) == (x.shape, BF16, (2, 485))
    assert n1._forward(torch.empty(3, 8, dtype=BF16), torch.empty(8), None, EPS,
                       BF16, stats=False) == ("eager",)
    assert len(launched) == 1 and launched[0][-1] is False


# --- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: N1 is a CUDA kernel with no CPU mode")
    return CUDA


MANTISSA = {BF16: 7, F32: 23}
# f32 noise of the statistics where |y| or |dx| is tiny: N1 and the chain
# sum a row in other orders (two passes against Welford), so their f32
# values before the one rounding differ by a few f32 ulps of the row's
# scale
NOISE = 1e-5


def ulp(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The spacing of `dtype`'s numbers at |v|."""
    _, e = torch.frexp(v.float().abs())
    return torch.ldexp(torch.ones_like(v, dtype=F32), e - 1 - MANTISSA[dtype])


def within_one_ulp(got: torch.Tensor, want: torch.Tensor, scale: float) -> bool:
    """Each element of `got` within one ulp of `want` in their dtype (at the
    larger magnitude of the two), or within NOISE * scale."""
    top = torch.maximum(got.float().abs(), want.float().abs())
    gap = (got.float() - want.float()).abs()
    return bool((gap <= ulp(top, want.dtype).clamp(min=NOISE * scale)).all())


def case(cuda, rows, d, dtype, bias=True, seed=0, offset=3.0):
    """x (rows, d) with a mean offset (the two-pass mean's test), a weight
    near 1 and a small bias, all from one seed."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = (torch.randn(rows, d, generator=g, device=cuda) * 2 + offset).to(dtype)
    w = 1 + 0.1 * torch.randn(d, generator=g, device=cuda)
    b = 0.1 * torch.randn(d, generator=g, device=cuda) if bias else None
    return x, w, b


def chain(x, w, b, out_dtype):
    return n1.layer_norm_ref(x, w, b, EPS, out_dtype)


# the port's widths (CLIPSeg's decoder 64, CLIP's text 512, the ViTs 768,
# ViT-L 1024, CRIS's FFN norm 2048, the widest the gate takes) and rows
# that fill no block (D = 64 puts 32 rows in a block, 768 eight)
SHAPES = [(37, 64), (3, 96), (5, 512), (9, 768), (1000, 768), (7, 1024),
          (3, 2048), (5, n1.MAX_D), (300, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d", SHAPES)
def test_n1_forward_is_the_chain_within_one_output_ulp(cuda, rows, d):
    x, w, b = case(cuda, rows, d, BF16, bias=d != 512)
    before = n1.launch_count()
    y, mean, rstd = library.layer_norm(x, w, b, EPS, BF16)
    torch.cuda.synchronize()
    assert n1.launch_count() == before + 1
    assert y.dtype == BF16 and y.shape == x.shape
    assert within_one_ulp(y, chain(x, w, b, BF16), scale=1.0)
    x64 = x.double()
    m64 = x64.mean(-1)
    r64 = (x64.var(-1, unbiased=False) + EPS).rsqrt()
    std = 1 / r64
    assert ((mean.double() - m64).abs() <= 1e-6 * (m64.abs() + std)).all()
    assert ((rstd.double() - r64).abs() <= 1e-6 * r64).all()


@pytest.mark.gpu
def test_n1_forward_at_the_vit_shape(cuda):
    """The flagship's 21 calls a step: 64 x 485 rows of 768, bf16 in and out.
    A call no gradient follows keeps no statistics, and gives the op's y."""
    x, w, b = case(cuda, 64 * 485, 768, BF16)
    x = x.view(64, 485, 768)
    y = n1.layer_norm(x, w, b, EPS, BF16)
    assert y.shape == x.shape and within_one_ulp(y, chain(x, w, b, BF16), scale=1.0)
    assert torch.equal(y, library.layer_norm(x, w, b, EPS, BF16)[0])


def grads(fn, x, w, b, dy):
    x, w = x.detach().requires_grad_(), w.detach().requires_grad_()
    b = None if b is None else b.detach().requires_grad_()
    y = fn(x, w, b)
    y.backward(dy)
    return y, x.grad, w.grad, None if b is None else b.grad


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d", [(37, 64), (1000, 768), (31040, 768), (33, 512),
                                    (3, 2048), (5, n1.MAX_D)])
def test_n1_backward_against_autograd_through_the_chain(cuda, rows, d):
    x, w, b = case(cuda, rows, d, BF16, bias=d != 33)
    g = torch.Generator(device=cuda).manual_seed(9)
    dy = torch.randn(rows, d, generator=g, device=cuda).to(BF16)
    before = n1.bwd_launch_count()
    _, dx, dw, db = grads(lambda *a: n1.layer_norm(*a, EPS, BF16), x, w, b, dy)
    torch.cuda.synchronize()
    assert n1.bwd_launch_count() == before + 1
    _, dx_ref, dw_ref, db_ref = grads(lambda *a: chain(*a, BF16), x, w, b, dy)
    assert dx.dtype == BF16 and dw.dtype == F32
    assert within_one_ulp(dx, dx_ref, scale=dx_ref.abs().max().item())
    # f32 sums over the rows in two fixed orders: a few f32 ulps of the sum of
    # the terms' magnitudes
    xh = (x.double() - x.double().mean(-1, keepdim=True)) * (
        x.double().var(-1, unbiased=False, keepdim=True) + EPS).rsqrt()
    mag_w = (dy.double() * xh).abs().sum(0)
    assert ((dw.double() - dw_ref.double()).abs() <= 1e-5 * mag_w + 1e-6).all()
    if b is not None:
        mag_b = dy.double().abs().sum(0)
        assert ((db.double() - db_ref.double()).abs() <= 1e-5 * mag_b + 1e-6).all()


@pytest.mark.gpu
def test_n1_backward_is_deterministic_and_skips_a_frozen_affine(cuda):
    x, w, b = case(cuda, 31040, 768, BF16)
    dy = torch.randn(31040, 768, device=cuda).bfloat16()
    first = grads(lambda *a: n1.layer_norm(*a, EPS, BF16), x, w, b, dy)
    second = grads(lambda *a: n1.layer_norm(*a, EPS, BF16), x, w, b, dy)
    assert all(torch.equal(p, q) for p, q in zip(first, second))
    xg = x.detach().requires_grad_()
    n1.layer_norm(xg, w, b, EPS, BF16).backward(dy)
    assert torch.equal(xg.grad, first[1]) and w.grad is None and b.grad is None


@pytest.mark.gpu
@pytest.mark.parametrize("wanted", ["x", "w", "b", "wb"])
def test_n1_backward_gives_the_gradients_asked_for(cuda, wanted):
    """Each subset of (x, weight, bias) that trains: a frozen affine writes
    no partial sums; a bias that trains alone still gets its sums."""
    x, w, b = case(cuda, 1000, 768, BF16)
    dy = torch.randn(1000, 768, device=cuda).bfloat16()
    leaves = {"x": x.detach(), "w": w.detach(), "b": b.detach()}
    for name in wanted:
        leaves[name].requires_grad_()
    n1.layer_norm(leaves["x"], leaves["w"], leaves["b"], EPS, BF16).backward(dy)
    ref = grads(lambda *a: chain(*a, BF16), x, w, b, dy)[1:]
    for (name, leaf), want in zip(leaves.items(), ref):
        if name in wanted:
            scale = want.abs().max().item()
            assert within_one_ulp(leaf.grad, want.to(leaf.grad.dtype), scale=scale * 10), name
        else:
            assert leaf.grad is None, name


@pytest.mark.gpu
def test_n1_under_cuda_graph_capture_replays_the_eager_result(cuda):
    x, w, b = case(cuda, 4 * 485, 768, BF16)
    dy = torch.randn(4 * 485, 768, device=cuda).bfloat16()
    xs, ws = x.detach().requires_grad_(), w.detach().requires_grad_()

    def step():
        y = n1.layer_norm(xs, ws, b, EPS, BF16)
        dx, dw = torch.autograd.grad(y, (xs, ws), dy)
        return y.detach(), dx, dw

    eager = step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = (n1.launch_count(), n1.bwd_launch_count())
    with torch.cuda.graph(graph):
        captured = step()
    assert (n1.launch_count(), n1.bwd_launch_count()) == (before[0] + 1, before[1] + 1)
    for t in captured:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(captured, eager))


@pytest.mark.gpu
def test_the_module_counts_n1_and_the_plain_chain(cuda):
    n1.reset_launch_count()
    for dim, dtype, x_dtype in ((768, BF16, BF16), (768, F32, F32), ((4, 3, 3), BF16, BF16)):
        ln = LayerNorm(dim, dtype=dtype).to(cuda)
        init_params(ln, torch.Generator().manual_seed(0))
        shape = (2, 5, dim) if isinstance(dim, int) else (2, *dim)
        x = torch.randn(shape, device=cuda).to(x_dtype).requires_grad_()
        ln(x).float().sum().backward()
    torch.cuda.synchronize()
    assert (n1.launch_count(), n1.bwd_launch_count(), n1.plain_count()) == (1, 1, 2)
