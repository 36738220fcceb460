"""Kernels K1, K2, K3 and K4, the sweeps' variants S1-S4, and the port's
serving and training paths on a CUDA GPU. These tests need the card (a CUDA kernel has no CPU mode) and skip
elsewhere; they import no JAX.
On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_*.py

(`--noconftest` because tests/conftest.py configures JAX, which the GPU
machine does not have; the JAX parity modules then skip themselves.)
"""
import pytest
import torch

from tunevlseg_torch.nn import attention
from tunevlseg_torch.ops import build
from tunevlseg_torch.ops import conv_flat as cf
from tunevlseg_torch.ops import flash_attention as fa
from tunevlseg_torch.ops import flash_attention_variants as fav
from tunevlseg_torch.ops import layer_norm as ln

pytestmark = pytest.mark.gpu

KERNEL_TOL = 2e-2  # bf16 output, a few ulp at |o| ~ 1
# K2's bf16 outputs against its plain version given the same lse:
# about one bf16 ulp of the largest magnitude (p and ds rounded from f32
# values that differ in the last bits, another summation order, one output
# rounding); K2 is deterministic
K2_REL_TOL = 5e-3
# K1's log-sum-exp against its plain version, relative to max(1, |lse|)
LSE_REL_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: K1 is a CUDA kernel with no CPU mode")
    return torch.device("cuda")


def _qkv(cuda, b, s, h, d, t=None, dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return tuple(torch.randn(b, n, h, d, generator=g, device=cuda).to(dtype)
                 for n in (s, t or s, t or s))


# K1's tile edges: a block owns 128 query rows, a ring stage 64 keys, and the
# keys' maps end at kv_valid
K1_EDGES = [
    ((3, 129, 2, 32), 129, None),      # one query row past a block
    ((3, 300, 2, 32), 300, None),      # ragged tail of 44 rows
    ((2, 150, 2, 16), 64, 64),         # one key tile, every key valid
    ((2, 150, 2, 32), 65, 64),         # one key past a tile, masked
    ((2, 150, 2, 64), 65, 65),         # one key past a tile, valid
    ((2, 150, 2, 32), 130, 128),       # kv_valid at a tile edge
    ((2, 150, 2, 64), 130, 129),       # one valid key past a tile edge
    ((2, 300, 2, 64), 200, 150),       # S > T, ragged tails of both
]


@pytest.mark.parametrize("shape,t,kv_valid", [
    ((64, 485, 12, 64), 485, None),    # vision tower
    ((64, 485, 4, 16), 485, None),     # CLIPSeg decoder
    ((64, 512, 12, 64), 512, 485),     # padded keys masked by kv_valid
    ((3, 70, 2, 32), 130, 99),         # ragged tails, S != T
    *K1_EDGES,
    ((64, 676, 8, 64), 676, None),     # CRIS decoder
    ((16, 485, 4, 16), 485, None),     # CLIPSeg decoder in the e2e step (b16)
    ((32, 485, 8, 64), 485, None),     # TransformerSegmentor decoder (b32)
    ((16, 576, 12, 64), 576, None),    # SigLIP vision tower at 384^2 (b16)
    ((16, 576, 16, 32), 576, None),    # PhraseCut's decoder, D = 32
    # D = 96, three column chunks of 32: model=trans_seg_siglip's decoder
    # (b32, 22^2 tokens), keys short of S, and K1's tile edges
    ((32, 484, 8, 96), 484, None),
    ((4, 512, 8, 96), 512, 485),
    ((3, 129, 2, 96), 65, 64),
    ((2, 300, 2, 96), 200, 150),
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


@pytest.mark.parametrize("shape,t,kv_valid", [
    ((64, 485, 12, 64), 485, None), ((8, 489, 4, 16), 489, None),
    ((4, 512, 12, 64), 512, 485), ((3, 77, 2, 32), 130, 99),
    *K1_EDGES,
    ((8, 676, 8, 64), 676, None),      # CRIS decoder, cut in batch
    ((16, 485, 4, 16), 485, None),
    ((8, 484, 8, 96), 484, None),      # trans_seg_siglip's decoder, cut in batch
    ((2, 150, 2, 96), 130, 129),
])
def test_k1_log_sum_exp_matches_plain_version(cuda, shape, t, kv_valid):
    """With the lse a backward asks for, K1's output keeps its bits and the
    lse (log2 domain, masked keys out) is its plain version's."""
    q, k, v = _qkv(cuda, *shape, t=t)
    plain_out = fa._launch(q, k, v, kv_valid or t)
    out, lse = fa._launch(q, k, v, kv_valid or t, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, plain_out)
    b, s, h, _ = shape
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    _, want = fa.flash_attention_ref(q, k, v, kv_valid, return_lse=True)
    assert ((lse - want).abs() / want.abs().clamp(min=1.0)).max().item() <= LSE_REL_TOL


@pytest.mark.parametrize("shape,t,kv_valid", [
    ((64, 485, 12, 64), 485, None), ((64, 485, 4, 16), 485, None),
    ((2, 150, 2, 32), 130, 129), ((32, 484, 8, 96), 484, None),
])
def test_k1_two_calls_are_bit_identical(cuda, shape, t, kv_valid):
    """No atomics and a fixed order of the sums: the same inputs give the
    same bits, output and log-sum-exp."""
    q, k, v = _qkv(cuda, *shape, t=t)
    first = fa._launch(q, k, v, kv_valid or t, with_lse=True)
    second = fa._launch(q, k, v, kv_valid or t, with_lse=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


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


def _assert_k2_close(got, want):
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape and a.dtype == torch.bfloat16, name
        top = w.float().abs().max().item()
        assert (a.float() - w.float()).abs().max().item() <= K2_REL_TOL * top, name


@pytest.mark.parametrize("shape,t,kv_valid", [
    ((64, 485, 12, 64), 485, None),    # vision tower
    ((64, 485, 4, 16), 485, None),     # CLIPSeg decoder
    ((64, 512, 12, 64), 512, 485),     # padded keys masked by kv_valid
    ((3, 300, 2, 32), 300, None),      # ragged tail of 44 rows, D = 32
    ((3, 70, 2, 32), 130, 99),         # S != T with kv_valid
    ((4, 77, 2, 16), 77, None),        # ragged S at every head dim
    ((4, 130, 2, 32), 130, None),
    ((4, 489, 3, 64), 489, None),
    ((4, 485, 2, 16), 512, 485),       # S != T, masked keys, D = 16
    ((32, 485, 8, 64), 485, None),     # TransformerSegmentor decoder (b32)
    ((16, 576, 16, 32), 576, None),    # PhraseCut's decoder, D = 32
    ((32, 484, 8, 96), 484, None),     # trans_seg_siglip's decoder, D = 96
    ((4, 512, 8, 96), 512, 485),       # D = 96 with keys short of S
    ((3, 300, 2, 96), 300, None),      # D = 96, ragged tails (dq blocks of 128)
])
@pytest.mark.parametrize("strided_g", [False, True], ids=["g", "strided_g"])
def test_k2_matches_plain_version(cuda, shape, t, kv_valid, strided_g):
    """K2 on the lse that K1 wrote, against its plain version given the
    same: masked dk / dv rows exactly 0, two calls bit-identical; g also as
    the strided view a (B, H, S, D) -> (B, S, H, D) transpose gives."""
    q, k, v = _qkv(cuda, *shape, t=t)
    b, s, h, d = shape
    g = _qkv(cuda, b, h, s, d, seed=1)[0].transpose(1, 2) if strided_g else \
        _qkv(cuda, *shape, seed=1)[0]
    assert g.is_contiguous() != strided_g
    _, lse = fa._launch(q, k, v, kv_valid or t, with_lse=True)
    before = fa.bwd_launch_count(), fa.launch_count()
    got = fa.flash_attention_bwd(q, k, v, g, kv_valid=kv_valid, lse=lse)
    torch.cuda.synchronize()
    assert (fa.bwd_launch_count(), fa.launch_count()) == (before[0] + 1, before[1])
    _assert_k2_close(got, fa.flash_attention_bwd_ref(q, k, v, g, kv_valid, lse=lse))
    # and the exact function (p = e / Σe): the same bound
    _assert_k2_close(got, fa.flash_attention_bwd_ref(q, k, v, g, kv_valid))
    if kv_valid is not None:
        assert bool((got[1][:, kv_valid:] == 0).all())
        assert bool((got[2][:, kv_valid:] == 0).all())
    again = fa.flash_attention_bwd(q, k, v, g, kv_valid=kv_valid, lse=lse)
    assert all(torch.equal(a, b) for a, b in zip(got, again))   # no atomics
    # without the lse, K1 runs first to make it: the same bits
    alone = fa.flash_attention_bwd(q, k, v, g, kv_valid=kv_valid)
    assert fa.launch_count() == before[1] + 1
    assert all(torch.equal(a, b) for a, b in zip(got, alone))


def test_backward_launches_k2_with_a_strided_gradient(cuda):
    q, k, v = (x.requires_grad_() for x in _qkv(cuda, 2, 300, 2, 32))
    out = fa.flash_attention(q, k, v)
    # the gradient as it comes through a (B, H, S, D) -> (B, S, H, D) transpose
    g = _qkv(cuda, 2, 2, 300, 32, seed=2)[0].transpose(1, 2)
    assert not g.is_contiguous()
    before = fa.bwd_launch_count()
    out.backward(g)
    torch.cuda.synchronize()
    assert fa.bwd_launch_count() == before + 1
    _, lse = fa._launch(q.detach(), k.detach(), v.detach(), 300, with_lse=True)
    want = fa.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), g, lse=lse)
    _assert_k2_close((q.grad, k.grad, v.grad), want)
    # a layout K2 cannot read in place (rows not 16-byte aligned) is copied
    odd = torch.zeros(2, 300, 2, 40, device=cuda, dtype=torch.bfloat16)[..., 4:36]
    odd.copy_(g)
    got = fa.flash_attention_bwd(q.detach(), k.detach(), v.detach(), odd, lse=lse)
    _assert_k2_close(got, want)


def test_backward_on_the_card_never_takes_the_plain_version(cuda, monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(fa, "flash_attention_bwd_ref", boom)
    monkeypatch.setattr(fa, "flash_attention_ref", boom)
    monkeypatch.setattr(attention, "plain_attention", boom)
    monkeypatch.setattr(fa, "_lse2", boom)
    q, k, v = (x.requires_grad_() for x in _qkv(cuda, 2, 256, 2, 32))
    k1, k2 = fa.launch_count(), fa.bwd_launch_count()
    attention.dot_product_attention(q, k, v).float().sum().backward()
    torch.cuda.synchronize()
    assert (fa.launch_count(), fa.bwd_launch_count()) == (k1 + 1, k2 + 1)
    assert all(bool(x.grad.isfinite().all()) for x in (q, k, v))
    # the public backward without the lse: K1 makes it, then K2
    g = torch.ones_like(q)
    fa.flash_attention_bwd(q.detach(), k.detach(), v.detach(), g)
    torch.cuda.synchronize()
    assert (fa.launch_count(), fa.bwd_launch_count()) == (k1 + 2, k2 + 2)


def test_kernels_with_tensor_maps_launch_from_a_fresh_thread(cuda):
    """K1, K2, K3, S1/S2/S4 and S3 encode TMA tensor maps on the host with
    cuTensorMapEncodeTiled, which needs a current context: a thread that has
    made no CUDA call yet (as autograd's backward thread) must launch them all
    the same."""
    import threading
    q, k, v = _qkv(cuda, 2, 300, 2, 64)
    g = _qkv(cuda, 2, 2, 300, 64, seed=2)[0].transpose(1, 2)
    bias = _key_pad(cuda, 2, 77, 30)

    def launch_all():
        return (fa.flash_attention_bwd(q, k, v, g), fav.attention_ones_column(q, k, v),
                fa._launch(q, k, v, 300, with_lse=True), fav.attention_variant(q, k, v),
                fa.biased_attention(q, k[:, :77].contiguous(), v[:, :77].contiguous(), bias))

    want = launch_all()
    torch.cuda.synchronize()
    got, errors = [], []

    def run():
        try:
            got.append(launch_all())
            torch.cuda.synchronize()
        except Exception as e:  # handed to the test's thread
            errors.append(e)

    worker = threading.Thread(target=run)
    worker.start()
    worker.join(timeout=300)
    assert not worker.is_alive()
    assert not errors, errors
    assert all(torch.equal(a, b) for a, b in zip(got[0][0], want[0]))
    assert torch.equal(got[0][1], want[1])
    assert all(torch.equal(a, b) for a, b in zip(got[0][2], want[2]))
    assert torch.equal(got[0][3], want[3])
    assert torch.equal(got[0][4], want[4])


def test_k2_raises_on_what_it_does_not_take(cuda):
    q48, k48, v48 = _qkv(cuda, 2, 64, 2, 48)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_bwd(q48, k48, v48, q48)
    q, k, v = _qkv(cuda, 2, 64, 2, 32)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention_bwd(q.float(), k.float(), v.float(), q.float())
    with pytest.raises(ValueError, match="gradient"):
        fa.flash_attention_bwd(q, k, v, q[:, :32])
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd(q, k.cpu(), v, q)
    _, lse = fa._launch(q, k, v, 64, with_lse=True)
    with pytest.raises(ValueError, match="lse must be"):
        fa.flash_attention_bwd(q, k, v, q, lse=lse[:, :1])


def _narrow_model(cuda, strategy):
    """A narrow CLIPSeg in bf16 for 256^2 images (257 tokens, vision heads
    of 32 dims, decoder heads of 16): 4 vision layers + 3 decoder blocks
    (K1), and 4 text layers of width 16 in ONE head of 16 dims (K3: the gate
    sends a biased call at a head dim K3 is not built for to K3, which
    raises; the tiny config's two heads of 8 would)."""
    from tunevlseg_torch.models.clip.config import (CLIPSegConfig, CLIPTextConfig,
                                                    CLIPVisionConfig)
    from tunevlseg_torch.models.presets import build_clipseg
    from tunevlseg_torch.training.task import SegmentationTask

    cfg = CLIPSegConfig.tiny(
        text=CLIPTextConfig(vocab_size=49408, hidden_size=16, num_layers=4, num_heads=1,
                            intermediate_size=32, max_position_embeddings=77),
        vision=CLIPVisionConfig(hidden_size=64, num_layers=4, num_heads=2,
                                intermediate_size=128, patch_size=16,
                                image_size=32),
        reduce_dim=32, decoder_num_heads=2)
    model, spec = build_clipseg(strategy, prompt_depth=3, num_context=4,
                                config=cfg, dtype=torch.bfloat16, device=cuda)
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(3, 999, (1, 77), generator=g, dtype=torch.int32)
    ids[:, 0], ids[:, 9:] = 49406, 49407
    batch = {"image": torch.randint(0, 256, (4, 3, 256, 256), generator=g,
                                    dtype=torch.uint8),
             "mask": (torch.rand(4, 1, 256, 256, generator=g) > 0.5).float(),
             "input_ids": ids, "attention_mask": (ids != 49407).int(),
             "text_index": torch.zeros(4, dtype=torch.int32),
             "valid": torch.tensor([1.0, 1.0, 1.0, 0.0])}
    return (SegmentationTask(model, spec, learning_rate=1e-3),
            {k: x.to(cuda) for k, x in batch.items()})


def test_coop_forward_saves_nothing_for_the_frozen_vision_tower(cuda):
    """In the CoOp step no input or weight of the vision tower needs a
    gradient: its K1 calls keep no q, k, v, and autograd saves no tensor of
    the vision attention's (B, 257, 2, 32) shape at all."""
    task, batch = _narrow_model(cuda, "coop")
    task.init()
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda x: saved.append(tuple(x.shape)) or x, lambda x: x):
        loss, _ = task._loss(batch)
    assert loss.requires_grad
    assert (4, 257, 2, 16) in saved            # the decoder's q, k, v are kept
    assert (4, 257, 2, 32) not in saved
    assert not any(s[-1] == 64 for s in saved if len(s) == 3)   # vision width


@pytest.mark.parametrize("strategy,k2_per_step", [("coop", 3), ("e2e", 7)])
def test_small_model_train_step_kernel_path_matches_plain_path(cuda, strategy,
                                                               k2_per_step):
    """One train step of the narrow model: 7 K1 launches, K2 for the decoder
    blocks (and the vision layers when they train), and loss and gradients
    that agree with the all-plain path (two bf16 models that round the
    scores at different places: loss 2e-2, each gradient leaf within 10% of
    its largest entry or of 1e-2 of the largest gradient entry overall; the
    key biases are left out, their gradient is zero in exact arithmetic and
    rounding noise in bf16)."""
    from unittest import mock

    task, batch = _narrow_model(cuda, strategy)
    start = {k: v.detach().clone() for k, v in task.model.state_dict().items()}

    def step():
        task.model.load_state_dict(start)
        _, metrics = task.train_step(task.init(), batch)
        return metrics["loss"].item(), {
            n: p.grad.float().clone() for n, p in task.model.named_parameters()
            if p.grad is not None}

    k1, k2 = fa.launch_count(), fa.bwd_launch_count()
    loss_k, grads_k = step()
    assert (fa.launch_count() - k1, fa.bwd_launch_count() - k2) == (7, k2_per_step)
    with mock.patch.object(attention, "_kernel_eligible", lambda *a: False):
        loss_p, grads_p = step()
    assert abs(loss_k - loss_p) <= 2e-2
    assert set(grads_k) == set(grads_p) and grads_k
    overall = max(g.abs().max().item() for g in grads_p.values())
    for name, want in grads_p.items():
        if name.endswith("k_proj.bias"):
            continue
        bound = 0.1 * max(want.abs().max().item(), 1e-2 * overall)
        assert (grads_k[name] - want).abs().max().item() <= bound, name


@pytest.mark.parametrize("strategy,plain_launches,remat_launches", [
    ("coop", (7, 3, 4), (7, 3, 8)), ("e2e", (7, 7, 4), (11, 7, 8))])
def test_small_model_remat_step_matches_plain_step(cuda, strategy, plain_launches,
                                                   remat_launches):
    """One train step of the narrow model with `remat=True` against the plain
    step from the same weights: per-layer remat reruns K1 in the 4 vision
    layers when they train (e2e; CoOp's frozen tower keeps nothing to
    recompute) and K3 in the 4 text layers, K2 stays one a K1 of the first
    forward; the same kernels on the same inputs give the same loss and the
    same gradients, bit for bit."""
    from tunevlseg_torch.training.task import SegmentationTask

    task, batch = _narrow_model(cuda, strategy)
    start = {k: v.detach().clone() for k, v in task.model.state_dict().items()}
    results = []
    for remat_on, launches in ((False, plain_launches), (True, remat_launches)):
        t = SegmentationTask(task.model, task.freeze_spec, learning_rate=1e-3,
                             remat=remat_on)
        task.model.load_state_dict(start)
        before = (fa.launch_count(), fa.bwd_launch_count(), fa.bias_launch_count())
        _, metrics = t.train_step(t.init(), batch)
        torch.cuda.synchronize()
        after = (fa.launch_count(), fa.bwd_launch_count(), fa.bias_launch_count())
        assert tuple(a - b for a, b in zip(after, before)) == launches
        results.append((metrics["loss"], {
            n: p.grad.clone() for n, p in task.model.named_parameters()
            if p.grad is not None},
            {k: v.clone() for k, v in task.model.state_dict().items()}))
    (loss_p, grads_p, weights_p), (loss_r, grads_r, weights_r) = results
    assert torch.equal(loss_p, loss_r)
    assert set(grads_p) == set(grads_r) and grads_p
    for name, g in grads_p.items():
        assert torch.equal(g, grads_r[name]), name
    for name, w in weights_p.items():
        assert torch.equal(w, weights_r[name]), name


def test_gate_routes_only_unbiased_long_bf16(cuda):
    """K1 takes unbiased bf16 self-attention at S >= 256 and nothing else; a
    bias or S != T goes to K3 at any length; f32 and short unbiased
    self-attention stay on the plain path."""
    q, k, v = _qkv(cuda, 2, 256, 2, 32)
    before, before3 = fa.launch_count(), fa.bias_launch_count()
    attention.dot_product_attention(q, k, v)
    assert fa.launch_count() == before + 1
    short = _qkv(cuda, 2, 255, 2, 32)
    attention.dot_product_attention(*short)
    attention.dot_product_attention(*(x.float() for x in (q, k, v)))
    assert (fa.launch_count(), fa.bias_launch_count()) == (before + 1, before3)
    bias = torch.zeros(1, 1, 256, 256, device=cuda)
    attention.dot_product_attention(q, k, v, bias=bias)
    attention.dot_product_attention(*short, bias=bias[..., :255, :255])
    attention.dot_product_attention(short[0], k, v)              # S != T
    assert (fa.launch_count(), fa.bias_launch_count()) == (before + 1, before3 + 3)
    # a head dim the kernels are not built for reaches K3 and raises there,
    # as it does at K1 (test_gate_raises_on_head_dim_k1_lacks)
    odd = _qkv(cuda, 2, 40, 2, 24, t=77)
    with pytest.raises(ValueError, match="head dims"):
        attention.dot_product_attention(*odd, bias=torch.zeros(2, 1, 1, 77, device=cuda))
    with pytest.raises(ValueError, match="head dims"):
        attention.dot_product_attention(*odd)                    # S != T, no bias
    assert fa.bias_launch_count() == before3 + 3


F32_MIN = torch.finfo(torch.float32).min


def _key_pad(cuda, b, t, first_pad):
    bias = torch.zeros(b, 1, 1, t, device=cuda)
    for i in range(b):
        bias[i, ..., first_pad - i % 7:] = F32_MIN
    return bias


def _causal(cuda, s):
    return torch.triu(torch.full((s, s), F32_MIN, device=cuda), 1)[None, None]


def _k3_bias(cuda, label, b, s, h, t):
    """The bias of a K3 case, by the first word of its label."""
    kind = label.split()[0]
    if kind == "text":
        bias = _causal(cuda, s) + _key_pad(cuda, b, t, 14)   # holds -inf too
        assert bool(bias.isneginf().any())
        return bias
    if kind == "full":
        return torch.randn(b, h, s, t, device=cuda)
    if kind == "no":
        return None
    if kind == "inf":
        # -inf over the first 64 keys of some rows and over a whole 80-key
        # tile of others: the running maximum is -inf after that tile
        bias = torch.randn(b, h, s, t, device=cuda)
        bias[:, :, ::3, :64] = float("-inf")
        bias[:, :, 1::3, :80] = float("-inf")
        return bias
    if kind == "min":
        # rows entirely at dtype-min: p uniform over their keys
        bias = _key_pad(cuda, b, t, t - 20).expand(b, h, s, t).clone()
        bias[:, :, ::5] = F32_MIN
        return bias
    return _key_pad(cuda, b, t, 14)


# K3's tile edges: 128 query rows a tile, a block taking a run of a pair's
# query tiles, 80 keys a tile, up to two key tiles resident (more stream
# through the ring), the keys' maps ending at kv_valid
K3_EDGES = [
    ("cross S=129", (3, 129, 2, 64), 77, None),
    ("cross T=65", (2, 150, 2, 64), 65, None),
    ("cross T=80 d32", (2, 150, 2, 32), 80, None),
    ("cross T=81 d16", (2, 150, 2, 16), 81, None),
    ("cross T=128", (2, 150, 2, 64), 128, None),
    ("cross T=129 d32", (2, 150, 2, 32), 129, None),
    ("cross kv_valid 80", (2, 150, 2, 64), 129, 80),
    ("cross kv_valid 64 d16", (2, 150, 2, 16), 129, 64),
    ("cross T=245, streamed", (2, 300, 2, 64), 245, None),
    ("cross T=400 kv_valid 333 d32, streamed", (2, 520, 2, 32), 400, 333),
    ("cross one pair, six query tiles", (1, 676, 1, 64), 77, None),
    ("cross runs of three query tiles", (25, 676, 4, 32), 77, None),
    ("cross runs of three, streamed", (25, 676, 4, 64), 245, 200),
    ("inf over a key tile", (2, 150, 2, 64), 129, None),
    ("min rows d32", (2, 150, 2, 32), 77, None),
    ("full bias T=129 d16", (2, 150, 2, 16), 129, None),
    ("no bias T=81", (2, 150, 2, 64), 81, None),
]


@pytest.mark.parametrize("label,shape,t,kv_valid", [
    ("text U=1", (1, 77, 8, 64), 77, None),
    ("text U=64", (64, 77, 8, 64), 77, None),
    ("cris cross", (64, 676, 8, 64), 77, None),
    # the TransformerSegmentor's cross-attention into the text (key-pad
    # bias): CLIP at b32, PhraseCut's SigLIP at b16; SigLIP's padded text
    ("trans_seg cross", (32, 485, 8, 64), 77, None),
    ("phrasecut cross d32", (16, 576, 16, 32), 64, None),
    ("siglip pad-only text", (16, 64, 12, 64), 64, None),
    # trans_seg_siglip's cross-attention at D = 96: 484 queries into the 64
    # SigLIP text keys, key-pad bias; and with keys short of T
    ("trans_seg_siglip cross d96", (32, 484, 8, 96), 64, None),
    ("cross d96 kv_valid", (4, 484, 8, 96), 64, 10),
    ("cross d96 T=245, streamed", (2, 300, 2, 96), 245, 200),
    ("full bias d96", (2, 150, 2, 96), 129, None),
    ("cross d32 kv_valid", (3, 70, 2, 32), 130, 99),
    ("full bias d16", (2, 100, 4, 16), 50, 45),
    ("no bias S != T", (3, 70, 2, 32), 130, None),
    *K3_EDGES,
])
def test_k3_matches_plain_version(cuda, label, shape, t, kv_valid):
    b, s, h, d = shape
    q, k, v = _qkv(cuda, *shape, t=t)
    bias = _k3_bias(cuda, label, b, s, h, t)
    before = fa.bias_launch_count()
    out = fa.biased_attention(q, k, v, bias, kv_valid=kv_valid)
    torch.cuda.synchronize()
    assert fa.bias_launch_count() == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert bool(out.isfinite().all())
    ref = fa.biased_attention_ref(q, k, v, bias, kv_valid=kv_valid)
    assert (out.float() - ref.float()).abs().max().item() <= KERNEL_TOL
    if bias is not None:
        # an expanded view of the same bias reads the same memory: stride 0
        full = bias.expand(b, h, s, t)
        again = fa.biased_attention(q, k, v, full, kv_valid=kv_valid)
        assert torch.equal(again, out)


@pytest.mark.parametrize("label,shape,t,kv_valid", [
    ("text U=64", (64, 77, 8, 64), 77, None),
    ("cris cross", (64, 676, 8, 64), 77, None),
    ("cross T=400 kv_valid 333 d32, streamed", (2, 520, 2, 32), 400, 333),
    ("trans_seg_siglip cross d96", (32, 484, 8, 96), 64, None),
])
def test_k3_two_calls_are_bit_identical(cuda, label, shape, t, kv_valid):
    """No atomics and a fixed order of the sums: the same inputs give the
    same bits."""
    b, s, h, d = shape
    q, k, v = _qkv(cuda, *shape, t=t)
    bias = _k3_bias(cuda, label, b, s, h, t)
    first = fa.biased_attention(q, k, v, bias, kv_valid=kv_valid)
    second = fa.biased_attention(q, k, v, bias, kv_valid=kv_valid)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_k3_backward_recomputes_on_the_plain_path(cuda):
    """K3 has no backward kernel, as its TPU counterpart: the gradient is
    autograd through `plain_attention`, and the forward still launches K3."""
    q, k, v = (x.requires_grad_() for x in _qkv(cuda, 2, 77, 8, 64))
    bias = _causal(cuda, 77) + _key_pad(cuda, 2, 77, 20)
    k2, k3 = fa.bwd_launch_count(), fa.bias_launch_count()
    out = attention.dot_product_attention(q, k, v, bias=bias)
    g = _qkv(cuda, 2, 77, 8, 64, seed=3)[0]
    out.backward(g)
    torch.cuda.synchronize()
    assert (fa.bwd_launch_count(), fa.bias_launch_count()) == (k2, k3 + 1)
    qkv = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(attention.plain_attention(*qkv, bias), qkv, g)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        assert torch.equal(got, w)


def test_k3_raises_on_what_it_does_not_take(cuda):
    q, k, v = _qkv(cuda, 2, 40, 2, 32, t=77)
    bias = torch.zeros(2, 1, 1, 77, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        fa.biased_attention(q, k, v, bias.bfloat16())
    with pytest.raises(ValueError, match="broadcast"):
        fa.biased_attention(q, k, v, bias[..., :70])
    with pytest.raises(ValueError, match="no gradient"):
        fa.biased_attention(q, k, v, bias.clone().requires_grad_())
    with pytest.raises(ValueError, match="bias on"):
        fa.biased_attention(q, k, v, bias.cpu())
    with pytest.raises(ValueError, match="bfloat16"):
        fa.biased_attention(q.float(), k.float(), v.float(), bias)
    with pytest.raises(ValueError, match="contiguous"):
        fa.biased_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, bias)
    q48, k48, v48 = _qkv(cuda, 2, 40, 2, 48, t=77)
    with pytest.raises(ValueError, match="head dims"):
        fa.biased_attention(q48, k48, v48, bias)
    # contiguous, but a batch of one with a stride TMA cannot step
    odd = torch.randn(4000, device=cuda).bfloat16().as_strided((1, 40, 2, 32),
                                                                (3, 64, 32, 1))
    assert odd.is_contiguous()
    with pytest.raises(ValueError, match="multiples of 8"):
        fa.biased_attention(odd, k[:1], v[:1], bias[:1])


def test_small_cris_kernel_path_matches_plain_path(cuda):
    """A narrow CRIS + CoOp in bf16 at 480^2 (a 30 x 30 decoder map: 900
    tokens; decoder and text heads of 16 dims; the attention pool's 225
    tokens stay under K1's gate): 2 decoder layers launch K1
    and, in the train step, K2; 3 text layers and 2 cross-attentions launch
    K3; probabilities, loss and the context gradient agree with the all-plain
    path, and frozen tensors and BatchNorm buffers stay as they were."""
    from unittest import mock

    from tunevlseg_torch.models.cris.model import CRISConfig
    from tunevlseg_torch.models.presets import build_cris
    from tunevlseg_torch.training.task import SegmentationTask

    cfg = CRISConfig.tiny(img_size=480, embed_dim=32, transformer_width=32,
                          fpn_in=(128, 256, 32), vis_dim=32, fpn_out=(16, 32, 32),
                          dropout=0.1)
    model, spec = build_cris("coop", prompt_depth=2, num_context=4, config=cfg,
                             dtype=torch.bfloat16, device=cuda)
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(3, 999, (1, 77), generator=g, dtype=torch.int32)
    ids[:, 0], ids[:, 9], ids[:, 10:] = 49406, 49407, 0
    batch = {"image": torch.randint(0, 256, (2, 3, 480, 480), generator=g,
                                    dtype=torch.uint8),
             "mask": (torch.rand(2, 1, 480, 480, generator=g) > 0.5).float(),
             "input_ids": ids, "attention_mask": (ids != 0).int(),
             "text_index": torch.zeros(2, dtype=torch.int32)}
    batch = {k: x.to(cuda) for k, x in batch.items()}
    task = SegmentationTask(model, spec, learning_rate=1e-3)
    plain = mock.patch.object(attention, "_kernel_eligible", lambda *a: "")

    def counts():
        return fa.launch_count(), fa.bwd_launch_count(), fa.bias_launch_count()

    before = counts()
    probs = task.predict_step(batch)
    assert tuple(a - b for a, b in zip(counts(), before)) == (2, 0, 5)
    with plain:
        assert (probs - task.predict_step(batch)).abs().max().item() <= 2e-2
    assert probs.shape == (2, 1, 480, 480) and bool(probs.isfinite().all())

    start = {k: x.detach().clone() for k, x in model.state_dict().items()}

    def step():
        model.load_state_dict(start)
        _, metrics = task.train_step(task.init(), batch)
        return metrics["loss"].item(), model.learner.context_vectors.grad.float().clone()

    before = counts()
    loss_k, grad_k = step()
    assert tuple(a - b for a, b in zip(counts(), before)) == (2, 2, 5)
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    frozen += [n for n, _ in model.named_buffers()]
    now = model.state_dict()
    assert all(torch.equal(now[n], start[n]) for n in frozen) and len(frozen) > 100
    with plain:
        loss_p, grad_p = step()
    assert abs(loss_k - loss_p) <= 2e-2
    assert (grad_k - grad_p).abs().max().item() <= 0.1 * grad_p.abs().max().item()


@pytest.mark.parametrize("op,d", [("K1", 96), ("K1 lse", 64), ("K3", 96),
                                  ("K3 no bias", 32), ("K4", 0), ("K4 dx", 0),
                                  ("N1", 768), ("N1 no bias", 64)])
def test_op_fake_implementation_matches_the_launch(cuda, op, d):
    """Each `tunevlseg::` op's fake implementation (what a torch.export
    trace reads) gives the shapes and dtypes of its CUDA launch's outputs;
    a call of the op counts one launch of its kernel, a traced call none."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from tunevlseg_torch.ops import library
    if op.startswith("N1"):
        x = torch.randn(2, 77, d, device=cuda).bfloat16()
        w = torch.randn(d, device=cuda)
        args = (x, w, None if op == "N1 no bias" else torch.randn(d, device=cuda),
                1e-5, torch.bfloat16)
        fn, count = library.layer_norm, ln.launch_count
    elif op.startswith("K4"):
        spec = cf.make_flat_spec(12, 12, 1)
        x = torch.randn(2, spec.rows, 16, device=cuda).bfloat16()
        w = torch.randn(24, 9, 16, device=cuda).bfloat16()
        scale = torch.ones(24, device=cuda)
        args = (x, w, scale, torch.zeros_like(scale), None, spec.rows, 3, spec.wp,
                spec.hp, spec.r, spec.mb, True, op == "K4 dx", 0)
        fn, count = library.conv_flat, (cf.dx_launch_count if op == "K4 dx"
                                        else cf.launch_count)
    else:
        q, k, v = _qkv(cuda, 2, 150, 2, d, t=77)
        if op.startswith("K1"):
            q, k, v = _qkv(cuda, 2, 150, 2, d)
            args, fn, count = (q, k, v, 150, op == "K1 lse"), library.flash_attn_fwd, \
                fa.launch_count
        else:
            bias = None if op == "K3 no bias" else _key_pad(cuda, 2, 77, 14)
            args, fn, count = (q, k, v, bias, 77), library.biased_attn_fwd, \
                fa.bias_launch_count
    before = count()
    real = fn(*args)
    torch.cuda.synchronize()
    assert count() == before + 1
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = fn(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                    for a in args))
    assert count() == before + 1
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(t.shape, t.dtype, t.device) for t in fake] == \
        [(t.shape, t.dtype, t.device) for t in real]


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

    task, batch = _narrow_model(cuda, "coop")
    before = fa.launch_count()
    probs = task.predict_step(batch)
    assert fa.launch_count() == before + 7
    with mock.patch.object(attention, "_kernel_eligible", lambda *a: False):
        plain = task.predict_step(batch)
    assert probs.shape == (4, 1, 256, 256) and bool(probs.isfinite().all())
    assert (probs - plain).abs().max().item() <= 2e-2


# --- K4, the flat guard-banded convolution -----------------------------------

# K4 against its plain version, bf16 outputs: both take the same bf16
# operands and accumulate in f32 (in another order), so an output differs by
# one rounding to bf16: 2^-8 of the largest |reference| (5e-3 with slack)
K4_REL_TOL = 5e-3
# the same bound stated exactly: one bf16 ulp of the largest |reference|. An
# ulp is 2^-7 of a value at the bottom of its binade, so where the largest
# output lies just above a power of two (4.6875 in a 256 -> 256 case) a sum
# that rounds the other way there differs by 2^-7 of it, over K4_REL_TOL
K4_ULP_TOL = 2 ** -7


def _flat_case(cuda, b, h, w, c, o, k, affine=True, res=False, seed=0, mb=None):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda)

    spec = cf.make_flat_spec(h, w, 1, mb=mb, max_k2c=9 * c)
    x = cf.flat_begin(rnd(b, h, w, c).bfloat16(), spec)
    wt = rnd(o, c, k, k) * (k * k * c) ** -0.5
    scale = rnd(o).abs() + 0.5 if affine else None
    offset = rnd(o) * 0.1 if affine else None
    residual = cf.flat_begin(rnd(b, h, w, o).bfloat16(), spec) if res else None
    return spec, x, wt, scale, offset, residual


def _k4_ref(spec, x, wt, scale, offset, relu, residual):
    o, i, k, _ = wt.shape
    w_mat = wt.permute(2, 3, 1, 0).reshape(k * k * i, o)
    ones = torch.ones(o, device=x.device)
    return cf.conv_flat_ref(spec, relu, x, w_mat, ones if scale is None else scale,
                            0 * ones if offset is None else offset, residual)


@pytest.mark.parametrize("b,hw,c,o,k,relu,affine,res,mb", [
    (2, (13, 13), 512, 512, 3, True, True, False, None),     # stage 4
    (2, (13, 13), 512, 2048, 1, True, True, True, None),     # widen + residual
    (2, (52, 52), 128, 128, 3, True, True, False, None),
    (1, (104, 104), 32, 64, 3, True, True, False, None),     # stem widths
    (1, (40, 40), 32, 32, 3, True, True, False, None),       # Cout under the tile
    (3, (9, 11), 8, 24, 3, False, False, False, 64),         # ragged: C, Cout, ROWS
    (3, (7, 5), 40, 72, 1, True, True, True, 64),            # ragged 1x1
    (2, (10, 12), 16, 136, 3, False, True, True, 64),        # ragged wide tile
    # one tile of 96 rows: the first taps read rows before 0, the last ones
    # rows past ROWS (both zero-filled by the TMA unit)
    (2, (6, 6), 16, 16, 3, True, True, True, 16),
])
def test_k4_matches_plain_version(cuda, b, hw, c, o, k, relu, affine, res, mb):
    spec, x, wt, scale, offset, residual = _flat_case(cuda, b, *hw, c, o, k,
                                                      affine, res, mb=mb)
    before = cf.launch_count()
    out = cf.conv_flat(x, spec, wt, scale, offset, relu, residual)
    torch.cuda.synchronize()
    assert cf.launch_count() == before + 1
    assert out.shape == (b, spec.rows, o) and out.dtype == torch.bfloat16
    ref = _k4_ref(spec, x, wt, scale, offset, relu, residual)
    if hw == (13, 13):   # 768 rows for 225 padded pixels: tiles of guard rows alone
        assert spec.mb + spec.lead >= 128
    top = ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= K4_REL_TOL * top
    # every row is written, guard and ring rows as exact zeros
    assert bool((out[:, ~cf._valid_rows(spec, cuda)] == 0).all())
    assert torch.equal(out, cf.conv_flat(x, spec, wt, scale, offset, relu, residual))


@pytest.mark.parametrize("block_n", [64, 128, 256])
@pytest.mark.parametrize("b,hw,c,o,k,relu,affine,res", [
    (2, (13, 13), 512, 2048, 1, True, True, True),       # stage 4 widening
    (2, (26, 26), 256, 256, 3, False, False, False),     # stage 3, no epilogue
    (1, (52, 52), 32, 136, 3, True, True, False),        # BK 32, ragged Cout
])
def test_k4_every_tile_width_matches_plain_version(cuda, block_n, b, hw, c, o, k,
                                                   relu, affine, res):
    """Each of K4's tile widths (64, 128 and 256 output channels), forced on
    shapes the choice by Cout would give another, and the input-gradient form
    (the weight transposed, its taps reversed) against the plain version of
    the flipped weight; two launches give the same bits."""
    spec, x, wt, scale, offset, residual = _flat_case(cuda, b, *hw, c, o, k,
                                                      affine, res)
    w_mat = wt.permute(2, 3, 1, 0).reshape(k * k * c, o)
    ones = torch.ones(o, device=cuda)
    sc = ones if scale is None else scale
    of = 0 * ones if offset is None else offset
    out = cf._launch(spec, relu, x, w_mat, scale, offset, residual, k, False,
                     block_n)
    ref = cf.conv_flat_ref(spec, relu, x, w_mat, sc, of, residual)
    top = ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= K4_ULP_TOL * top
    assert bool((out[:, ~cf._valid_rows(spec, cuda)] == 0).all())
    again = cf._launch(spec, relu, x, w_mat, scale, offset, residual, k, False,
                       block_n)
    assert torch.equal(out, again)
    # the input gradient's form: a cotangent with Cout channels in, C out
    dy = cf.flat_begin(torch.randn(b, *hw, o, device=cuda).bfloat16(), spec)
    dx = cf._launch(spec, False, dy, w_mat, None, None, None, k, True, block_n)
    ones_c = torch.ones(c, device=cuda)
    ref = cf.conv_flat_ref(spec, False, dy, cf._flipped(w_mat, c), ones_c,
                           0 * ones_c, None)
    top = ref.float().abs().max().item()
    assert dx.shape == (b, spec.rows, c)
    assert (dx.float() - ref.float()).abs().max().item() <= K4_ULP_TOL * top
    assert bool((dx[:, ~cf._valid_rows(spec, cuda)] == 0).all())


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("want", [(True, True, True), (True, False, False),
                                  (False, True, False), (False, False, True)])
@pytest.mark.parametrize("o", [64, 24, 2048])
def test_k4_dy_prologue_matches_plain_version(cuda, relu, want, o):
    """The backward's prologue kernel against its plain version: dy * scale
    in bf16 (channel 0's scale exactly 0), dy in bf16, and the f32 sum of dy
    over batch and rows, each only where asked for, in one pass; two launches
    give the same bits. dy is exact in bf16 (a bf16 cotangent times 0 or 1),
    so both bf16 outputs are equal to the bit; the sums differ by f32
    rounding in another order (1e-5 of the sum of |dy|)."""
    h = 13 if o == 2048 else 20
    spec, x, wt, scale, offset, _ = _flat_case(cuda, 3, h, h, 16, o, 1, mb=None)
    scale[0] = 0.0
    out = cf.conv_flat(x, spec, wt, scale, offset, relu)
    g = torch.randn(out.shape, device=cuda).bfloat16()
    before = cf.dy_launch_count()
    got = cf._dy_prologue(spec, relu, g, out, scale, *want)
    again = cf._dy_prologue(spec, relu, g, out, scale, *want)
    torch.cuda.synchronize()
    assert cf.dy_launch_count() == before + 2
    ref = cf.dy_prologue_ref(spec, relu, g, out, scale, torch.bfloat16, *want)
    for name, a, b, r in zip(("dy * scale", "dy", "sum of dy"), got, ref, again):
        assert (a is None) == (b is None) == (r is None), name
        if a is None:
            continue
        assert torch.equal(a, r), name
        if name == "sum of dy":
            scale_of = (g.float().abs().sum((0, 1)) + 1).max().item()
            assert (a - b).abs().max().item() <= 1e-5 * scale_of, name
        else:
            assert a.dtype == torch.bfloat16 and torch.equal(a, b), name
    if want[0]:
        assert bool((got[0][..., 0] == 0).all())


def test_k4_backward_launches_k4_for_dx_and_matches_autograd(cuda):
    """The autograd.Function on the card: dx is a K4 launch (counted apart),
    and all five gradients agree with autograd through the plain version in
    f32 on the same bf16-rounded inputs (bf16 operands in the dW products:
    1e-2 of the largest entry)."""
    spec, x, wt, scale, offset, residual = _flat_case(cuda, 2, 12, 10, 32, 64, 3,
                                                      True, True, mb=64)
    leaves = [t.clone().requires_grad_() for t in (x, wt, scale, offset, residual)]
    fwd, dx, dy = cf.launch_count(), cf.dx_launch_count(), cf.dy_launch_count()
    out = cf.conv_flat(leaves[0], spec, leaves[1], leaves[2], leaves[3], True,
                       leaves[4])
    g = torch.randn(out.shape, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(9)).bfloat16()
    g = g * cf._valid_rows(spec, cuda)[None, :, None]
    out.backward(g)
    torch.cuda.synchronize()
    assert (cf.launch_count(), cf.dx_launch_count(), cf.dy_launch_count()) == (
        fwd + 1, dx + 1, dy + 1)

    ref = [t.detach().float().requires_grad_() for t in (x, wt, scale, offset, residual)]
    w_mat = ref[1].bfloat16().float().permute(2, 3, 1, 0).reshape(-1, 64)
    # the masked ReLU state of the kernel's own output, as the Function uses it
    mask = (out > 0).float()
    lead = spec.lead
    xg = torch.nn.functional.pad(ref[0], (0, 0, lead, lead))
    acc = sum(xg[:, lead + off:lead + off + spec.rows] @ w_mat[t * 32:(t + 1) * 32]
              for t, off in enumerate(cf._tap_offsets(spec, 3)))
    pre = acc * ref[2] + ref[3] + ref[4]
    (pre * mask * g.float()).sum().backward()
    valid = cf._valid_rows(spec, cuda)
    # by its contract the Function's dx is zero on guard and ring rows, where
    # autograd through the plain products has the taps' true cotangent
    assert bool((leaves[0].grad[:, ~valid] == 0).all())
    ref[0].grad[:, ~valid] = 0
    for name, got, want in zip(("dx", "dw", "d_scale", "d_offset", "d_residual"),
                               leaves, ref):
        top = want.grad.abs().max().item()
        err = (got.grad.float() - want.grad).abs().max().item()
        assert err <= 1e-2 * top, (name, err, top)


def test_k4_on_the_card_never_takes_the_plain_version(cuda, monkeypatch):
    spec, x, wt, scale, offset, _ = _flat_case(cuda, 1, 8, 8, 16, 16, 3, mb=64)

    def boom(*a, **kw):
        raise AssertionError("the plain version ran on a bf16 CUDA tensor")

    monkeypatch.setattr(cf, "conv_flat_ref", boom)
    wt.requires_grad_()
    x.requires_grad_()
    cf.conv_flat(x, spec, wt, scale, offset, True).float().sum().backward()
    torch.cuda.synchronize()
    assert bool(x.grad.isfinite().all()) and bool(wt.grad.isfinite().all())
    # f32 on the card is the plain version's, by the dispatch rule
    monkeypatch.undo()
    before = cf.launch_count()
    out = cf.conv_flat(x.detach().float(), spec, wt.detach(), scale, offset, True)
    assert out.dtype == torch.float32 and cf.launch_count() == before


def test_k4_raises_on_what_it_does_not_take(cuda):
    spec, x, wt, scale, offset, _ = _flat_case(cuda, 1, 8, 8, 16, 16, 3, mb=64)
    with pytest.raises(ValueError, match="multiples of 8"):
        cf.conv_flat(x[..., :12].contiguous(), spec, wt[:, :12])
    with pytest.raises(ValueError, match="multiples of 8"):
        cf.conv_flat(x, spec, wt[:12])
    with pytest.raises(ValueError, match="contiguous"):
        cf.conv_flat(x.repeat(1, 1, 2)[..., :16], spec, wt)
    with pytest.raises(ValueError, match="residual"):
        cf.conv_flat(x, spec, wt, residual=x[:, :-8].contiguous())
    with pytest.raises(ValueError, match="bfloat16 residual"):
        cf.conv_flat(x, spec, wt, residual=x.float())
    with pytest.raises(ValueError, match="CUDA device"):
        cf.conv_flat(x, spec, wt, scale.cpu(), offset)
    with pytest.raises(AssertionError):
        cf.conv_flat(x[:, :-8], spec, wt)                     # not the spec's rows


def test_a_build_failure_raises(cuda, monkeypatch, tmp_path):
    """A source that does not compile raises from the first launch: no
    fallback to the plain version."""
    bad = tmp_path / "conv_flat.cu"
    bad.write_text("this is not CUDA C++\n")
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(cf, "_lib", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setitem(build.SOURCES, "conv", bad)
    spec, x, wt, scale, offset, _ = _flat_case(cuda, 1, 8, 8, 16, 16, 3, mb=64)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cf.conv_flat(x, spec, wt, scale, offset)


# --- S1-S4, the variants of K1 -----------------------------------------------

VARIANT_SWITCHES = [
    dict(), dict(use_exp2=True), dict(skip_max=True),
    dict(use_exp2=True, skip_max=True), dict(gemm_only=True),
    dict(hg=2), dict(hg=6), dict(bg=2, hg=3, block_order="head"),
    dict(bg=4, hg=1), dict(hg=3, block_order="head", use_exp2=True),
]


@pytest.mark.parametrize("shape,t,kv_valid", [
    ((4, 70, 6, 64), 130, 99),         # ragged tails, S != T, masked keys
    ((4, 128, 6, 64), 128, None),      # whole tiles
    ((4, 489, 6, 64), 489, None),      # the vision tower with four contexts
    ((4, 300, 6, 64), 200, 150),       # S > T, ragged tails of both
])
@pytest.mark.parametrize("kw", VARIANT_SWITCHES,
                         ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items())
                         or "default")
def test_variants_match_plain_version(cuda, shape, t, kv_valid, kw):
    """S1, S2, S4: every switch against its plain version; bf16 outputs, a
    few ulp at |o| ~ 1, scaled by the largest |reference| without a softmax."""
    q, k, v = _qkv(cuda, *shape, t=t)
    before = fav.launch_count("variant")
    out = fav.attention_variant(q, k, v, kv_valid, **kw)
    torch.cuda.synchronize()
    assert fav.launch_count("variant") == before + 1
    ref = fav.attention_variant_ref(q, k, v, kv_valid, **kw)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    bound = KERNEL_TOL * max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= bound
    if not kw.get("gemm_only"):
        # the blocking and the block order change no value: K1's function
        k1 = fa.flash_attention(q, k, v, kv_valid=kv_valid)
        assert (out.float() - k1.float()).abs().max().item() <= KERNEL_TOL


@pytest.mark.parametrize("shape,t,kv_valid", [
    ((4, 70, 6, 64), 130, 99), ((4, 70, 6, 64), 130, None),
    ((4, 128, 6, 64), 128, None),      # nothing to mask: no mask row at all
    ((4, 77, 6, 64), 77, None), ((4, 489, 6, 64), 489, None),
    ((4, 300, 6, 64), 200, 150),       # S > T, ragged tails of both
])
@pytest.mark.parametrize("kw", [dict(), dict(skip_max=True),
                                dict(hg=3, bg=2, block_order="head"),
                                dict(hg=6, bg=4, skip_max=True),
                                dict(hg=2, block_order="head")],
                         ids=["default", "skip_max", "blocked", "blocked_skip_max",
                              "hg2_head"])
def test_ones_column_matches_plain_version(cuda, shape, t, kv_valid, kw):
    """S3 against its plain version, and within 2e-2 of K1: its denominator
    is the sum of the bf16-rounded p (about 2^-9 relative) and its scale is
    folded into q in bf16."""
    q, k, v = _qkv(cuda, *shape, t=t)
    before = fav.launch_count("ones_column")
    out = fav.attention_ones_column(q, k, v, kv_valid, **kw)
    torch.cuda.synchronize()
    assert fav.launch_count("ones_column") == before + 1
    ref = fav.attention_ones_column_ref(q, k, v, kv_valid, **kw)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert (out.float() - ref.float()).abs().max().item() <= KERNEL_TOL
    k1 = fa.flash_attention(q, k, v, kv_valid=kv_valid)
    assert (out.float() - k1.float()).abs().max().item() <= KERNEL_TOL
    assert (fav.mask_row(t, kv_valid or t, cuda) is None) == (t == 128)


def test_variants_raise_on_what_they_do_not_take(cuda):
    q, k, v = _qkv(cuda, 4, 64, 6, 64)
    for fn in (fav.attention_variant, fav.attention_ones_column):
        with pytest.raises(ValueError, match="hg=4"):
            fn(q, k, v, hg=4)
        with pytest.raises(ValueError, match="bfloat16"):
            fn(q.float(), k.float(), v.float())
        with pytest.raises(ValueError, match="contiguous"):
            fn(q.transpose(0, 1).contiguous().transpose(0, 1), k, v)
        with pytest.raises(ValueError, match="kv_valid"):
            fn(q, k, v, 0)
    q32, k32, v32 = _qkv(cuda, 4, 64, 6, 32)
    with pytest.raises(ValueError, match="head dim 64"):
        fav.attention_variant(q32, k32, v32)


def test_models_never_launch_a_variant(cuda):
    """The gate sends the models' attention to K1 / K3; S1-S4 are the
    sweeps' alone."""
    task, batch = _narrow_model(cuda, "maple")
    before = (fav.launch_count("variant"), fav.launch_count("ones_column"))
    task.train_step(task.init(), batch)
    torch.cuda.synchronize()
    assert (fav.launch_count("variant"), fav.launch_count("ones_column")) == before


# --- the strategies with visual contexts -------------------------------------

@pytest.mark.parametrize("strategy", ["vpt", "maple", "shared_separate",
                                      "shared_attn", "cocoop"])
def test_small_strategy_step_kernel_path_matches_plain_path(cuda, strategy):
    """One step of the narrow model (256^2: 257 tokens, 261 with the four
    visual contexts). Visual contexts send the gradient back through the
    frozen vision tower: 7 K1 and 7 K2 launches, none of the tower's
    parameters gets a gradient or moves. CoCoOp keeps the tower forward-only
    (7 K1, 3 K2) and runs the text tower on 4 rows. Loss and gradients
    against the path with every K1 / K2 call plain, the text tower's K3
    calls on K3 on both paths (the text ran on one path on both sides when
    its heads of 8 kept it off K3; K3 against its plain version is
    test_k3_matches_plain_version's), as in the CoOp test: loss 2e-2, each leaf
    within 10% of its largest entry or of 1e-2 of the largest entry overall
    (the Shared-Attention projector's q / k gradients are exact zeros on
    both paths); 20% under CoCoOp, whose meta-net also READS what differs
    between the paths (the pooled image features), so its weight gradients
    differ in both factors (measured 16% at these narrow widths, and 15%
    between two paths without a kernel: the test holds the kernel path to
    at most twice the latter)."""
    from unittest import mock

    task, batch = _narrow_model(cuda, strategy)
    if strategy == "cocoop":
        batch = dict(batch, input_ids=batch["input_ids"].expand(4, -1).contiguous(),
                     attention_mask=batch["attention_mask"].expand(4, -1).contiguous())
        del batch["text_index"]
    start = {k: v.detach().clone() for k, v in task.model.state_dict().items()}

    def step():
        task.model.load_state_dict(start)
        _, metrics = task.train_step(task.init(), batch)
        return metrics["loss"].item(), {
            n: p.grad.float().clone() for n, p in task.model.named_parameters()
            if p.grad is not None}

    k1, k2 = fa.launch_count(), fa.bwd_launch_count()
    loss_k, grads_k = step()
    want_k2 = 3 if strategy == "cocoop" else 7
    assert (fa.launch_count() - k1, fa.bwd_launch_count() - k2) == (7, want_k2)
    for name, p in task.model.named_parameters():
        if not p.requires_grad:
            assert p.grad is None and torch.equal(p, start[name]), name
    gate = attention._kernel_eligible

    def k1_calls_plain(q, k, bias):
        return "K3" if gate(q, k, bias) == "K3" else ""

    def plain_step(plain):
        with mock.patch.object(attention, "_kernel_eligible", k1_calls_plain), \
                mock.patch.object(attention, "plain_attention", plain):
            return step()

    def worst_difference(grads, grads_p):
        assert set(grads) == set(grads_p) and "learner.context_vectors" in grads
        overall = max(g.abs().max().item() for g in grads_p.values())
        return max(
            (grads[name] - want).abs().max().item()
            / max(want.abs().max().item(), 1e-2 * overall)
            for name, want in grads_p.items() if not name.endswith("k_proj.bias"))

    loss_p, grads_p = plain_step(attention.plain_attention)
    assert abs(loss_k - loss_p) <= 2e-2
    worst = worst_difference(grads_k, grads_p)
    print(f"{strategy}: kernel path vs plain path, worst gradient difference "
          f"{worst:.4f} of the leaf's scale")
    assert worst <= (0.2 if strategy == "cocoop" else 0.1)
    if strategy == "cocoop":
        # the wide bound is earned in the same run: two paths without a
        # kernel (the plain path, and the kernels' plain version with f32
        # scores) differ among themselves by at least half as much
        _, grads_f = plain_step(fa.biased_attention_ref)
        among = worst_difference(grads_f, grads_p)
        print(f"cocoop: the two plain paths among themselves {among:.4f}")
        assert 2 * among >= worst


@pytest.mark.parametrize("c,cout,side", [(104, 1, 40), (206, 104, 30),
                                         (512, 410, 39)])
def test_k4_upsampler_convolution_with_padded_channels(cuda, c, cout, side):
    """The TransformerSegmentor's flat upsampler convolution (`conv3_flat`):
    C and Cout zero-padded to multiples of 8 around one K4 launch (104 -> 1
    as 104 -> 8), against `F.conv2d` on the same bf16-rounded operands in
    f32, forward (K4_REL_TOL of the largest entry) and, through one dx and
    one prologue launch, the input, weight and bias gradients (1e-2 of the
    largest entry)."""
    from tunevlseg_torch.models.trans_segmentor.model import conv3_flat
    from tunevlseg_torch.nn.conv import Conv2d
    from tunevlseg_torch.nn.layers import init_params
    g = torch.Generator(device=cuda).manual_seed(4)
    conv = Conv2d(c, cout, 3, bias=True)
    init_params(conv, torch.Generator().manual_seed(4))
    conv = conv.to(cuda)
    x = torch.randn(2, c, side + 2, side + 2, generator=g, device=cuda).bfloat16()
    x.requires_grad_()
    counts = cf.launch_count(), cf.dx_launch_count(), cf.dy_launch_count()
    out = conv3_flat(x, conv)
    dy = torch.randn(out.shape, generator=g, device=cuda).bfloat16()
    out.backward(dy)
    torch.cuda.synchronize()
    assert (cf.launch_count(), cf.dx_launch_count(), cf.dy_launch_count()) == (
        counts[0] + 1, counts[1] + 1, counts[2] + 1)
    assert out.shape == (2, cout, side, side) and out.dtype == torch.bfloat16
    xr = x.detach().float().requires_grad_()
    wr = conv.weight.detach().bfloat16().float().requires_grad_()
    br = conv.bias.detach().float().requires_grad_()
    ref = torch.nn.functional.conv2d(xr, wr, br)
    top = ref.abs().max().item()
    assert (out.float() - ref).abs().max().item() <= K4_REL_TOL * top
    ref.backward(dy.float())
    for name, got, want in (("dx", x.grad, xr.grad), ("dw", conv.weight.grad, wr.grad),
                            ("db", conv.bias.grad, br.grad)):
        top = want.abs().max().item()
        assert (got.float() - want).abs().max().item() <= 1e-2 * top, name


@pytest.mark.parametrize("hw,c,o,k,res", [
    (256, 64, 64, 3, False),       # FreeSOLO's R101 res2 at a 1024^2 request
    (256, 64, 256, 1, True),
    (64, 1024, 256, 1, False),     # res4
    (32, 512, 2048, 1, True),      # res5
])
def test_k4_at_the_zero_shot_r101_shapes(cuda, hw, c, o, k, res):
    spec, x, wt, scale, offset, residual = _flat_case(cuda, 1, hw, hw, c, o, k,
                                                      res=res)
    out = cf.conv_flat(x, spec, wt, scale, offset, True, residual)
    ref = _k4_ref(spec, x.float(), wt.bfloat16().float(), scale, offset, True,
                  None if residual is None else residual.float())
    top = ref.abs().max().item()
    assert (out.float() - ref).abs().max().item() <= K4_REL_TOL * top
    assert bool((out[:, ~cf._valid_rows(spec, cuda)] == 0).all())


def _small_zero_shot(cuda, layout):
    """A narrow ZeroShotRIS on the card in bf16: text heads of 16 (K3 takes
    them), the tiny FreeSOLO (full-width R50) on `layout`."""
    from tunevlseg_torch.models.clip.config import (CLIPSegConfig, CLIPTextConfig,
                                                    CLIPVisionConfig)
    from tunevlseg_torch.models.solov2.model import SOLOv2, SOLOv2Config
    from tunevlseg_torch.models.zero_shot_ris.model import MaskedCLIP, ZeroShotRIS
    from tunevlseg_torch.nn.layers import init_params
    ccfg = CLIPSegConfig(
        text=CLIPTextConfig(hidden_size=32, num_layers=2, num_heads=2,
                            intermediate_size=64),
        vision=CLIPVisionConfig(hidden_size=32, num_layers=3, num_heads=2,
                                intermediate_size=64, patch_size=8, image_size=32),
        projection_dim=16)
    scfg = SOLOv2Config.tiny(fpn_channels=32, num_kernels=32, num_masks=32,
                             instance_channels=32, mask_channels=32)
    clip = MaskedCLIP(ccfg, torch.bfloat16)
    solo = SOLOv2(scfg, layout=layout, dtype=torch.bfloat16)
    init_params(clip, torch.Generator().manual_seed(0))
    init_params(solo, torch.Generator().manual_seed(1))
    return ZeroShotRIS(ccfg, scfg, clip.to(cuda).eval(), solo.to(cuda).eval(),
                       alpha=0.95, clip_image_size=32)


@pytest.mark.parametrize("layout", ["nchw", "flat"])
def test_small_zero_shot_request_launches_k3_and_k4(cuda, layout, monkeypatch):
    """A fused request: K3 in each text layer, K4 in the R50's 12 stride-1
    bottlenecks on "flat", no K1 (197-token ViTs and these 17 tokens are
    under its gate); the host loop gives a mask of the same shape, and its
    text features match the plain path's."""
    import numpy as np
    ris = _small_zero_shot(cuda, layout)
    g = torch.Generator().manual_seed(2)
    image = torch.randn(3, 64, 64, generator=g).numpy()
    ids = torch.randint(1, 1000, (2, 12), generator=g, dtype=torch.int32)
    ids[:, -1] = 49407
    ids, mask = ids.numpy(), np.ones((2, 12), np.int32)
    fa.reset_launch_count()
    cf.reset_launch_count()
    out = ris.predict_fused(image, ids, mask)
    assert (fa.launch_count(), fa.bias_launch_count(), cf.launch_count()) == (
        0, 2, 36 if layout == "flat" else 0)
    assert out.shape == (1, 1, 64, 64)
    assert ris(image, ids, mask).shape[1:] == (1, 64, 64)
    ids_t, mask_t = torch.from_numpy(ids).to(cuda), torch.from_numpy(mask).to(cuda)
    with torch.no_grad():
        kern = ris.clip.get_text_features(ids_t, mask_t).float()
        monkeypatch.setattr(attention, "_kernel_eligible", lambda *a: "")
        plain = ris.clip.get_text_features(ids_t, mask_t).float()
    assert (kern - plain).abs().max().item() <= 2e-2 * plain.abs().max().item()


def test_crop_resize_on_the_card_matches_the_host_crops(cuda):
    import numpy as np
    from tunevlseg_torch.models.zero_shot_ris.model import ZeroShotRIS
    from tunevlseg_torch.ops.image import crop_resize_bicubic_masked
    rng = np.random.default_rng(3)
    image = rng.normal(size=(3, 200, 240)).astype(np.float32)
    masks = rng.random((6, 200, 240)) > 0.4
    boxes = np.array([[4.7, 3.2, 130.9, 95.1], [-6, -3, 20, 12], [200, 150, 260, 215],
                      [10, 10, 11, 11], [12, 5, 9, 30], [0, 0, 240, 200]], np.float32)
    valid = np.ones(6, bool)
    got = crop_resize_bicubic_masked(*(torch.from_numpy(a).to(cuda)
                                       for a in (image, masks, boxes)), 224)
    want = ZeroShotRIS.host_crop_canvases(image, boxes, masks, valid, 224)
    assert (got.cpu() - torch.from_numpy(want)).abs().max().item() <= \
        1e-4 * np.abs(want).max()
