"""K4: the stride-1 "same" convolution on the flat guard-banded layout, with
a fused affine / residual / ReLU epilogue, forward and backward.

Counterpart of `tunevlseg_tpu/ops/conv_pallas.py`. Activations live in a
padded, row-flattened layout

    (B, ROWS, C)   pixel (h, w) of the zero-padded (Hp, Wp) plane
                   at row  MB + h*Wp + w,

so every tap (dy, dx) of a k x k convolution is a CONSTANT row offset
(dy-r)*Wp + (dx-r), and the convolution is k*k shifted-row matrix products
summed in f32. Rows [0, MB) and [MB + Hp*Wp, ROWS) are zero guard bands and
the r-ring of every plane is zero, and every output keeps them exactly zero,
which makes the layout chainable: a whole stride-1 stage (1x1s, 3x3s, folded
BatchNorm affines, residual adds, ReLUs) runs flat, with one copy in
(`flat_begin`) and one view out (`flat_end`).

`FlatSpec` and `make_flat_spec` keep the JAX package's geometry letter for
letter (`mb`, `qb`, `rows`, `lead`), so a flat tensor here compares element by
element with one there. On the TPU `mb` and `qb` size the kernel's bands from
a VMEM budget; here they only fix ROWS and the guard size, and the CUDA
kernel's tiles do not depend on them.

Dispatch, a rule and not a fallback: a bf16 CUDA tensor launches K4
(`tunevlseg_torch/csrc/conv_flat.cu`, built at first use by `ops/build.py`)
or raises; CPU tensors and f32 take `conv_flat_ref`, the kernel's plain
PyTorch version. The gradient is analytic on either device, as the JAX
package's `_conv_flat_bwd`: one pass over the cotangent (the prologue kernel
of the same source on the card, `dy_prologue_ref` elsewhere) gives dy * scale,
dy and the sum of dy; dx is a flat convolution with the transposed weight and
its taps reversed and goes through the same dispatch (so on the card dx
launches K4); dW is one matrix product per tap over the whole batch, outside
any kernel.

K4 is the `torch.library` custom op `tunevlseg::conv_flat` (`ops/library.py`),
whose CUDA implementation is `k4_cuda` here: a `torch.export` trace keeps it
in the program, and the launch counts are kept by that implementation (a
loaded program's launches count, a trace's do not).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from tunevlseg_torch.ops import build

_lib: Optional[ctypes.CDLL] = None
_launches = 0
_dx_launches = 0
_dy_launches = 0


def launch_count() -> int:
    """Number of K4 launches for a forward since the last reset."""
    return _launches


def dx_launch_count() -> int:
    """Number of K4 launches for an input gradient since the last reset."""
    return _dx_launches


def dy_launch_count() -> int:
    """Number of launches of the backward's prologue kernel since the last
    reset."""
    return _dy_launches


def reset_launch_count() -> None:
    """Set the K4 launch counts (forward, dx, prologue) to 0."""
    global _launches, _dx_launches, _dy_launches
    _launches = 0
    _dx_launches = 0
    _dy_launches = 0


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Geometry of one flat space: a stride-1 conv chain at fixed (H, W).

    All tensors in the space are (B, ROWS, C) with pixel (h, w) of the
    r-padded (Hp, Wp) plane at row MB + h*Wp + w; rows [0, MB) and
    [(nb_pix+1)*MB, ROWS) are zero guard bands, and the rows around the
    pixels inside the middle are forced to zero by every convolution.
    """

    h: int
    w: int
    r: int          # max tap radius hosted by this space (k <= 2r+1)
    mb: int         # guard band height, multiple of 8
    qb: int = 0     # the JAX kernel's halo granularity; kept for equality

    @property
    def hp(self) -> int:
        return self.h + 2 * self.r

    @property
    def wp(self) -> int:
        return self.w + 2 * self.r

    @property
    def mp(self) -> int:
        return self.hp * self.wp

    @property
    def lead(self) -> int:
        return self.r * self.wp + self.r

    @property
    def nb_pix(self) -> int:
        return -(-self.mp // self.mb)

    @property
    def rows(self) -> int:
        return (self.nb_pix + 2) * self.mb


def make_flat_spec(h: int, w: int, r: int = 1, mb: Optional[int] = None,
                   max_k2c: Optional[int] = None,
                   itemsize: int = 2) -> FlatSpec:
    """The JAX package's choice of `mb` and `qb` for an (h, w) plane: the
    band count under a cap of 2048 rows (less where `max_k2c * itemsize`
    rows of 4 MiB would be fewer), the padded pixel rows split evenly over
    the bands and rounded up to 128, never under the tap lead r*Wp + r;
    `qb = mb / d` for the largest d in 8, 4, 2, 1 that keeps it >= lead."""
    wp = w + 2 * r
    lead = r * wp + r
    mp = (h + 2 * r) * wp
    if mb is None:
        cap = 2048
        if max_k2c:
            cap = min(cap, (4 * 2 ** 20) // (max_k2c * itemsize))
        cap = _ceil_to(max(cap, lead, 128), 128)
        nbp = -(-mp // cap)
        mb = _ceil_to(max(-(-mp // nbp), lead, 128), 128)
    d = next((d for d in (8, 4, 2, 1) if mb % d == 0 and mb // d >= lead), 1)
    spec = FlatSpec(h, w, r, mb, mb // d)
    if spec.qb < spec.lead:
        raise ValueError(f"halo {spec.qb} < lead {spec.lead}")
    return spec


def flat_begin(x_nhwc: torch.Tensor, spec: FlatSpec,
               channels: Optional[int] = None) -> torch.Tensor:
    """(B, H, W, C) -> flat (B, ROWS, C) with zero pads and guard bands: one
    zero fill and one strided copy (any layout of `x_nhwc` is read in place).
    `channels` > C zero-pads the channels too, to (B, ROWS, channels)."""
    b, h, w, c = x_nhwc.shape
    assert (h, w) == (spec.h, spec.w), (tuple(x_nhwc.shape), spec)
    r = spec.r
    flat = x_nhwc.new_zeros(b, spec.rows, channels or c)
    plane = flat[:, spec.mb:spec.mb + spec.mp].unflatten(1, (spec.hp, spec.wp))
    plane[:, r:spec.hp - r, r:spec.wp - r, :c] = x_nhwc
    return flat


def flat_end(flat: torch.Tensor, spec: FlatSpec) -> torch.Tensor:
    """flat (B, ROWS, C) -> (B, H, W, C), a view that drops the guards and
    the spatial pad."""
    r = spec.r
    x = flat[:, spec.mb:spec.mb + spec.mp].unflatten(1, (spec.hp, spec.wp))
    return x[:, r:spec.hp - r, r:spec.wp - r]


def _tap_offsets(spec: FlatSpec, k: int) -> list[int]:
    r = k // 2
    return [(dy - r) * spec.wp + (dx - r) for dy in range(k) for dx in range(k)]


def _valid_rows(spec: FlatSpec, device=None) -> torch.Tensor:
    """(ROWS,) bool mask of pixel rows (guards and the r-ring are False)."""
    p = torch.arange(spec.rows, device=device) - spec.mb
    pc = p.clamp(min=0)
    hh, ww = pc // spec.wp, pc % spec.wp
    r = spec.r
    return ((p >= 0) & (hh >= r) & (hh < spec.hp - r)
            & (ww >= r) & (ww < spec.wp - r))


def _kernel_size(x: torch.Tensor, w_mat: torch.Tensor) -> int:
    k2 = w_mat.shape[0] // x.shape[-1]
    k = int(round(k2 ** 0.5))
    assert k * k * x.shape[-1] == w_mat.shape[0], (tuple(x.shape),
                                                   tuple(w_mat.shape))
    return k


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def conv_flat_ref(spec: FlatSpec, relu: bool, x: torch.Tensor,
                  w_mat: torch.Tensor, scale: torch.Tensor,
                  offset: torch.Tensor,
                  residual: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of K4 with the kernel's numerics. x (B, ROWS, C),
    w_mat (k*k*C, Cout) with the taps dy-major, then dx, then C; scale and
    offset f32 (Cout,); residual (B, ROWS, Cout) or None. Per tap a
    shifted-row product of x with the weight cast to x's dtype, accumulated
    in f32; then in f32 and in this order acc*scale + offset, + residual,
    ReLU, the validity mask (guard and ring rows exactly zero); one cast to
    x's dtype at the end."""
    c = x.shape[-1]
    k = _kernel_size(x, w_mat)
    lead = spec.lead
    xg = F.pad(x, (0, 0, lead, lead))
    acc = None
    for t, off in enumerate(_tap_offsets(spec, k)):
        sl = xg[:, lead + off:lead + off + spec.rows]
        part = sl.float() @ w_mat[t * c:(t + 1) * c].to(x.dtype).float()
        acc = part if acc is None else acc + part
    acc = acc * scale.float() + offset.float()
    if residual is not None:
        acc = acc + residual.float()
    if relu:
        acc = acc.clamp(min=0.0)
    valid = _valid_rows(spec, x.device)[None, :, None]
    return torch.where(valid, acc, 0.0).to(x.dtype)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def load_library() -> ctypes.CDLL:
    """Build the kernels from source where needed (`ops/build.py`) and set
    the argument types of K4's entry points. A failed build raises."""
    global _lib
    if _lib is None:
        lib = build.load_libraries()["conv"]
        lib.tvs_conv_flat.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 12
                                      + [ctypes.c_void_p])
        lib.tvs_conv_flat.restype = ctypes.c_int
        lib.tvs_conv_flat_dy.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                                         + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.tvs_conv_flat_dy.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_cuda(x: torch.Tensor, tensors, aligned: bool = True) -> None:
    """Raise unless every (name, tensor, dtype) lies on x's CUDA device with
    that dtype, contiguous and, with `aligned` (real tensors only: a traced
    call has no addresses), 16-byte aligned."""
    for name, t, dtype in tensors:
        if t.device != x.device or not t.is_cuda:
            raise ValueError(f"K4 needs every tensor on x's CUDA device; "
                             f"{name} is on {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"K4 takes a {dtype} {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"K4 takes contiguous tensors; {name} is not")
        if aligned and t.data_ptr() % 16:
            raise ValueError(f"K4 needs 16-byte aligned tensors; {name} is not")


def _check_kernel_inputs(spec, x, w_b, scale, offset, residual) -> None:
    """Raise on anything K4 does not take (the alignment `k4_cuda` checks)."""
    b, rows, c = x.shape
    cout = w_b.shape[0]
    tensors = [("x", x, torch.bfloat16), ("weight", w_b, torch.bfloat16)]
    if scale is not None:
        tensors += [("scale", scale, torch.float32), ("offset", offset, torch.float32)]
    if residual is not None:
        tensors.append(("residual", residual, torch.bfloat16))
    _check_cuda(x, tensors, aligned=False)
    if rows != spec.rows:
        raise ValueError(f"K4: x has {rows} rows, the spec {spec.rows}")
    if c % 8 or cout % 8:
        raise ValueError(f"K4 takes channel counts that are multiples of 8 "
                         f"(16-byte rows), got C = {c}, Cout = {cout}")
    if scale is not None and (scale.shape != (cout,) or offset.shape != (cout,)):
        raise ValueError(f"K4: scale {tuple(scale.shape)} and offset "
                         f"{tuple(offset.shape)} must be ({cout},)")
    if residual is not None and residual.shape != (b, rows, cout):
        raise ValueError(f"K4: residual {tuple(residual.shape)} is not "
                         f"{(b, rows, cout)}")
    if not 0 < b <= 65535 or -(-rows // 128) > 65535:
        raise ValueError(f"K4 grid out of range for x {tuple(x.shape)}")


def kernel_weight(w_mat: torch.Tensor, c: int, dtype: torch.dtype,
                  for_dx: bool = False) -> torch.Tensor:
    """The weight as K4 reads it, in one copy that casts and transposes:
    (Cout, k*k, C) for the forward, and (C, k*k, Cout) for the input
    gradient, whose launch pairs tap t with the weight's tap k*k-1-t."""
    k2 = w_mat.shape[0] // c
    w = w_mat.detach().reshape(k2, c, -1)
    w = w.permute(1, 0, 2) if for_dx else w.permute(2, 0, 1)
    return torch.empty(w.shape, dtype=dtype, device=w.device).copy_(w)


def _launch(spec: FlatSpec, relu: bool, x, w_mat, scale, offset, residual,
            k: int, for_dx: bool, block_n: int = 0) -> torch.Tensor:
    """One K4 launch, through its op. `w_mat` is the forward's (k*k*C, Cout)
    weight in both cases; for the input gradient (`for_dx`) x is the scaled
    cotangent and the kernel reads the weight transposed with its taps
    reversed. `block_n` forces the tile width (64, 128, 256; 0 chooses by
    Cout)."""
    if k % 2 != 1 or k // 2 > spec.r:
        raise ValueError(f"K4: kernel size {k} does not fit a spec of radius "
                         f"{spec.r}")
    w_b = kernel_weight(w_mat, w_mat.shape[0] // (k * k), x.dtype, for_dx)
    _check_kernel_inputs(spec, x, w_b, scale, offset, residual)
    if w_b.shape[2] != x.shape[-1]:
        raise ValueError(f"K4: x has {x.shape[-1]} channels, the weight "
                         f"{w_b.shape[2]}")
    return library.conv_flat(x, w_b, scale, offset, residual, spec.rows, k,
                             spec.wp, spec.hp, spec.r, spec.mb, relu, for_dx,
                             block_n)


def k4_cuda(x: torch.Tensor, w_b: torch.Tensor, scale: Optional[torch.Tensor],
            offset: Optional[torch.Tensor], residual: Optional[torch.Tensor],
            rows: int, k: int, wp: int, hp: int, r: int, mb: int, relu: bool,
            for_dx: bool, block_n: int) -> torch.Tensor:
    """One K4 launch: the CUDA implementation of `tunevlseg::conv_flat` on
    inputs `_launch` took; (B, rows, Cout) out, every row written (guard and
    ring rows as zeros). A forward launch counts in `launch_count`, an
    input gradient's (`for_dx`) in `dx_launch_count`."""
    global _launches, _dx_launches
    for name, t in (("x", x), ("weight", w_b), ("scale", scale),
                    ("offset", offset), ("residual", residual)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"K4 needs 16-byte aligned tensors; {name} is not")
    lib = load_library()
    cout = w_b.shape[0]
    out = torch.empty(x.shape[0], rows, cout, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        err = lib.tvs_conv_flat(
            x.data_ptr(), w_b.data_ptr(), ptr(scale), ptr(offset), ptr(residual),
            out.data_ptr(), x.shape[0], rows, x.shape[-1], cout, k, wp, hp, r,
            mb, int(relu), int(for_dx), block_n, stream)
    if err != 0:
        raise RuntimeError(f"K4 launch failed: cudaError {err}")
    if for_dx:
        _dx_launches += 1
    else:
        _launches += 1
    return out


def _flipped(w_mat: torch.Tensor, c: int) -> torch.Tensor:
    """W'[t'] = W[k*k-1-t']^T as a (k*k*Cout, C) matrix: the weight of the
    input gradient as a flat convolution (the tap offsets negate under index
    reversal)."""
    k2 = w_mat.shape[0] // c
    return (w_mat.detach().reshape(k2, c, -1).flip(0).transpose(1, 2)
            .reshape(-1, c))


def _dispatch(spec, relu, x, w_mat, scale, offset, residual, k, for_dx=False):
    """K4 for a bf16 CUDA tensor (or raise), else the plain version. With
    `for_dx`, x is the scaled cotangent and `w_mat` the forward's weight;
    scale and offset None mean 1 and 0."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        return _launch(spec, relu, x, w_mat, scale, offset, residual, k, for_dx)
    if for_dx:
        w_mat = _flipped(w_mat, w_mat.shape[0] // (k * k))
    if scale is None:
        scale = torch.ones(w_mat.shape[1], dtype=torch.float32, device=x.device)
        offset = torch.zeros_like(scale)
    return conv_flat_ref(spec, relu, x, w_mat, scale, offset, residual)


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------

def dy_prologue_ref(spec: FlatSpec, relu: bool, g: torch.Tensor,
                    out: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype,
                    want_scaled: bool, want_plain: bool, want_offset: bool):
    """Plain PyTorch version of the backward's prologue kernel: dy = g
    masked by the ReLU state (ties at 0 take the 0-branch), which also masks
    the rows the forward forced to zero, or else by those rows; returns
    (dy * scale in `dtype`, dy in `dtype`, the f32 sum of dy over batch and
    rows), each None where it is not wanted."""
    if relu:
        dy = g.float() * (out > 0)
    else:
        dy = g.float() * _valid_rows(spec, g.device)[None, :, None]
    return ((dy * scale.float()).to(dtype) if want_scaled else None,
            dy.to(dtype) if want_plain else None,
            dy.sum((0, 1)) if want_offset else None)


def _dy_rows_per_block(n_rows: int) -> int:
    """Rows a block of the prologue walks: 256, more where the grid would
    pass its 65535 row blocks."""
    return max(256, -(-n_rows // 65535))


def _dy_prologue(spec, relu, g, out, scale, want_scaled, want_plain,
                 want_offset):
    """The prologue kernel on a bf16 CUDA cotangent (or raise). The per-block
    sums of dy are added over the blocks by one `sum` in a fixed order."""
    global _dy_launches
    g = g.contiguous()
    b, rows, cout = g.shape
    _check_cuda(g, [("g", g, torch.bfloat16), ("out", out, torch.bfloat16),
                    ("scale", scale, torch.float32)])
    if rows != spec.rows or out.shape != g.shape or cout % 8:
        raise ValueError(f"K4 prologue: g {tuple(g.shape)}, out "
                         f"{tuple(out.shape)}, spec rows {spec.rows}")
    n_rows = b * rows
    per_block = _dy_rows_per_block(n_rows)
    dys = torch.empty_like(g) if want_scaled else None
    dyb = torch.empty_like(g) if want_plain else None
    part = (torch.empty(-(-n_rows // per_block), cout, dtype=torch.float32,
                        device=g.device) if want_offset else None)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = load_library()
    stream = torch.cuda.current_stream(g.device).cuda_stream
    with torch.cuda.device(g.device):
        err = lib.tvs_conv_flat_dy(
            g.data_ptr(), out.data_ptr(), scale.data_ptr(), ptr(dys), ptr(dyb),
            ptr(part), n_rows, rows, cout, spec.wp, spec.hp, spec.r, spec.mb,
            int(relu), per_block, stream)
    if err != 0:
        raise RuntimeError(f"K4 prologue launch failed: cudaError {err}")
    _dy_launches += 1
    return dys, dyb, None if part is None else part.sum(0)


def dy_prologue(spec, relu, g, out, scale, dtype, want_scaled, want_plain,
                want_offset):
    """The prologue kernel for a bf16 CUDA cotangent (or raise), else its
    plain version."""
    if g.is_cuda and g.dtype == torch.bfloat16 and dtype == torch.bfloat16:
        return _dy_prologue(spec, relu, g, out, scale, want_scaled, want_plain,
                            want_offset)
    return dy_prologue_ref(spec, relu, g, out, scale, dtype, want_scaled,
                           want_plain, want_offset)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with f32 sums and an f32 result, for operands in any dtype."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def weight_grad_taps(spec: FlatSpec, k: int, x: torch.Tensor,
                     dy: torch.Tensor) -> torch.Tensor:
    """dWt (k*k*C, Cout) = per tap x_shift(t)^T dy against the UNSCALED dy,
    each tap one product over every (batch, row) pair. x and dy are viewed
    as (B*ROWS, C) and (B*ROWS, Cout); tap t contracts rows [mb + off,
    B*ROWS - mb + off) of x with rows [mb, B*ROWS - mb) of dy. That is exact:
    dy is zero outside each image's pixel block, every pixel block lies in
    [mb, B*ROWS - mb), and |off| <= lead <= mb keeps the shifted rows inside
    the tensor; the rows where dy is zero (guard bands, the ring, the seams
    between images, whose shifted x rows belong to the neighbouring image)
    add exact zeros."""
    c, cout = x.shape[-1], dy.shape[-1]
    x2 = x.reshape(-1, c)
    d2 = dy.reshape(-1, cout)
    lo, hi = spec.mb, x2.shape[0] - spec.mb
    return torch.cat([_mm_f32(x2[lo + off:hi + off].t(), d2[lo:hi])
                      for off in _tap_offsets(spec, k)], 0)


class _ConvFlat(torch.autograd.Function):
    """The flat convolution with its analytic gradient. The inputs and the
    output are kept for the backward only when a gradient is wanted."""

    @staticmethod
    def forward(ctx, x, w_mat, scale, offset, residual, spec, relu):
        out = _dispatch(spec, relu, x, w_mat, scale, offset, residual,
                        _kernel_size(x, w_mat))
        ctx.spec, ctx.relu = spec, relu
        if any(ctx.needs_input_grad[:5]):
            ctx.save_for_backward(x, w_mat, scale, offset, residual, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w_mat, scale, offset, residual, out = ctx.saved_tensors
        spec, relu = ctx.spec, ctx.relu
        need_x, need_w, need_s, need_o, need_r = ctx.needs_input_grad[:5]
        k = _kernel_size(x, w_mat)
        # one pass over g (and out): dy * scale for dx, dy for dW / d_scale /
        # d_residual, and the sum of dy for d_offset, each only where wanted
        dys, dyb, d_offset = dy_prologue(spec, relu, g, out, scale, x.dtype,
                                         need_x, need_w or need_s or need_r,
                                         need_o)
        dx = dw = d_scale = d_res = None
        if need_x:
            # the transpose of a flat conv is a flat conv with the weight
            # transposed and its taps reversed (on the card: K4 again)
            dx = _dispatch(spec, False, dys, w_mat, None, None, None, k,
                           for_dx=True)
        if need_w or need_s:
            dwt = weight_grad_taps(spec, k, x, dyb)
            if need_w:
                dw = (dwt * scale.float()).to(w_mat.dtype)
            if need_s:
                # d_scale_o = sum dy*acc = sum_{t,c} W[tc,o] * dWt[tc,o]: exact
                # for scale == 0, no division, no forward recompute
                d_scale = (w_mat.float() * dwt).sum(0)
        if need_r:
            d_res = dyb.to(residual.dtype)
        return dx, dw, d_scale, d_offset, d_res, None, None


def conv_flat(flat: torch.Tensor, spec: FlatSpec, weight_oihw: torch.Tensor,
              scale: Optional[torch.Tensor] = None,
              offset: Optional[torch.Tensor] = None, relu: bool = False,
              residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stride-1 "same" convolution in flat space with a fused
    (scale * conv + offset [+ residual]) [ReLU] epilogue.

    weight_oihw: torch layout (O, I, k, k), k odd, k // 2 <= spec.r.
    scale / offset: per-channel f32 (fold a frozen BatchNorm or a bias here);
    residual: another flat (B, ROWS, O) tensor added before the ReLU.

    A bf16 CUDA `flat` launches K4 (channel counts multiples of 8,
    contiguous tensors) or raises; a CPU or f32 `flat` takes `conv_flat_ref`.

    Gradient contract: dL/dx is zero on the guard and ring rows (the forward
    forces those OUTPUT rows to zero, and its boundary taps do read the
    ring, so the true ring cotangent is not zero). That is exact for inputs
    made by `flat_begin` or by an earlier `conv_flat`, whose ring rows are
    forced constants; do not differentiate with respect to a hand-built flat
    tensor whose ring rows carry values that depend on trainable ones.
    """
    o, i, kh, kw = weight_oihw.shape
    assert kh == kw and kh % 2 == 1 and kh // 2 <= spec.r
    assert flat.shape[-1] == i and flat.shape[1] == spec.rows
    w_mat = weight_oihw.permute(2, 3, 1, 0).reshape(kh * kw * i, o)
    if scale is None:
        scale = torch.ones(o, dtype=torch.float32, device=flat.device)
    if offset is None:
        offset = torch.zeros(o, dtype=torch.float32, device=flat.device)
    return _ConvFlat.apply(flat, w_mat, scale.float(), offset.float(), residual,
                           spec, relu)


def conv2d_same_flat(x: torch.Tensor, weight_oihw: torch.Tensor,
                     scale: Optional[torch.Tensor] = None,
                     offset: Optional[torch.Tensor] = None, relu: bool = False,
                     layout: str = "nhwc",
                     spec: Optional[FlatSpec] = None) -> torch.Tensor:
    """One convolution through the flat layout (the JAX package's
    `conv2d_same_pallas`): flat_begin -> conv_flat -> flat_end, on an NHWC
    or NCHW tensor."""
    if layout == "nchw":
        x = x.permute(0, 2, 3, 1)
    _, h, w, c = x.shape
    k = weight_oihw.shape[2]
    if spec is None:
        spec = make_flat_spec(h, w, k // 2, max_k2c=k * k * c,
                              itemsize=x.element_size())
    out = flat_end(conv_flat(flat_begin(x, spec), spec, weight_oihw, scale,
                             offset, relu), spec)
    if layout == "nchw":
        out = out.permute(0, 3, 1, 2)
    return out


# the op `_launch` calls; registering it needs this module's launcher
from tunevlseg_torch.ops import library  # noqa: E402
