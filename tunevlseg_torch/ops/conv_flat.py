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
package's `_conv_flat_bwd`: dx is a flat convolution with the flipped,
transposed weight and goes through the same dispatch (so on the card dx
launches K4); dW is k*k matrix products outside any kernel.
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


def launch_count() -> int:
    """Number of K4 launches for a forward since the last reset."""
    return _launches


def dx_launch_count() -> int:
    """Number of K4 launches for an input gradient since the last reset."""
    return _dx_launches


def reset_launch_count() -> None:
    """Set both K4 launch counts to 0."""
    global _launches, _dx_launches
    _launches = 0
    _dx_launches = 0


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


def flat_begin(x_nhwc: torch.Tensor, spec: FlatSpec) -> torch.Tensor:
    """(B, H, W, C) -> flat (B, ROWS, C) with zero pads and guard bands: one
    zero fill and one strided copy (any layout of `x_nhwc` is read in place)."""
    b, h, w, c = x_nhwc.shape
    assert (h, w) == (spec.h, spec.w), (tuple(x_nhwc.shape), spec)
    r = spec.r
    flat = x_nhwc.new_zeros(b, spec.rows, c)
    plane = flat[:, spec.mb:spec.mb + spec.mp].unflatten(1, (spec.hp, spec.wp))
    plane[:, r:spec.hp - r, r:spec.wp - r] = x_nhwc
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
# the kernel
# ---------------------------------------------------------------------------

def load_library() -> ctypes.CDLL:
    """Build the kernels from source where needed (`ops/build.py`) and set
    the argument types of K4's entry point. A failed build raises."""
    global _lib
    if _lib is None:
        lib = build.load_libraries()["conv"]
        lib.tvs_conv_flat.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                                      + [ctypes.c_void_p])
        lib.tvs_conv_flat.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_kernel_inputs(spec, x, w_nk, scale, offset, residual) -> None:
    """Raise on anything K4 does not take."""
    b, rows, c = x.shape
    cout, k2c = w_nk.shape
    tensors = [("x", x, torch.bfloat16), ("weight", w_nk, torch.bfloat16),
               ("scale", scale, torch.float32), ("offset", offset, torch.float32)]
    if residual is not None:
        tensors.append(("residual", residual, torch.bfloat16))
    for name, t, dtype in tensors:
        if t.device != x.device or not t.is_cuda:
            raise ValueError(f"K4 needs every tensor on x's CUDA device; "
                             f"{name} is on {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"K4 takes a {dtype} {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"K4 takes contiguous tensors; {name} is not")
        if t.data_ptr() % 16:
            raise ValueError(f"K4 needs 16-byte aligned tensors; {name} is not")
    if rows != spec.rows:
        raise ValueError(f"K4: x has {rows} rows, the spec {spec.rows}")
    if c % 8 or cout % 8:
        raise ValueError(f"K4 takes channel counts that are multiples of 8 "
                         f"(16-byte rows), got C = {c}, Cout = {cout}")
    if scale.shape != (cout,) or offset.shape != (cout,):
        raise ValueError(f"K4: scale {tuple(scale.shape)} and offset "
                         f"{tuple(offset.shape)} must be ({cout},)")
    if residual is not None and residual.shape != (b, rows, cout):
        raise ValueError(f"K4: residual {tuple(residual.shape)} is not "
                         f"{(b, rows, cout)}")
    if not 0 < b <= 65535 or -(-rows // 128) > 65535:
        raise ValueError(f"K4 grid out of range for x {tuple(x.shape)}")


def _launch(spec: FlatSpec, relu: bool, x, w_mat, scale, offset, residual,
            for_dx: bool) -> torch.Tensor:
    """One K4 launch. The weight goes to the kernel as (Cout, k*k*C) in x's
    dtype: the cast the JAX wrapper makes once per call and the layout the
    kernel's B fragments want, in one copy."""
    global _launches, _dx_launches
    k = _kernel_size(x, w_mat)
    if k % 2 != 1 or k // 2 > spec.r:
        raise ValueError(f"K4: kernel size {k} does not fit a spec of radius "
                         f"{spec.r}")
    cout = w_mat.shape[1]
    w_nk = torch.empty(cout, w_mat.shape[0], dtype=x.dtype, device=x.device)
    w_nk.copy_(w_mat.detach().t())
    _check_kernel_inputs(spec, x, w_nk, scale, offset, residual)
    lib = load_library()
    # every row is written by the kernel, guard and ring rows as zeros
    out = torch.empty(x.shape[0], spec.rows, cout, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.tvs_conv_flat(
            x.data_ptr(), w_nk.data_ptr(), scale.data_ptr(), offset.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            x.shape[0], spec.rows, x.shape[-1], cout, k, spec.wp, spec.hp,
            spec.r, spec.mb, int(relu), stream)
    if err != 0:
        raise RuntimeError(f"K4 launch failed: cudaError {err}")
    if for_dx:
        _dx_launches += 1
    else:
        _launches += 1
    return out


def _dispatch(spec, relu, x, w_mat, scale, offset, residual, for_dx=False):
    """K4 for a bf16 CUDA tensor (or raise), else the plain version."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        return _launch(spec, relu, x, w_mat, scale, offset, residual, for_dx)
    return conv_flat_ref(spec, relu, x, w_mat, scale, offset, residual)


class _ConvFlat(torch.autograd.Function):
    """The flat convolution with its analytic gradient. The inputs and the
    output are kept for the backward only when a gradient is wanted."""

    @staticmethod
    def forward(ctx, x, w_mat, scale, offset, residual, spec, relu):
        out = _dispatch(spec, relu, x, w_mat, scale, offset, residual)
        ctx.spec, ctx.relu = spec, relu
        if any(ctx.needs_input_grad[:5]):
            ctx.save_for_backward(x, w_mat, scale, offset, residual, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w_mat, scale, offset, residual, out = ctx.saved_tensors
        spec, relu = ctx.spec, ctx.relu
        need_x, need_w, need_s, need_o, need_r = ctx.needs_input_grad[:5]
        c = x.shape[-1]
        k = _kernel_size(x, w_mat)
        k2 = k * k
        # dy masked by the ReLU state (ties at 0 take the 0-branch), which
        # also masks the rows the forward forced to zero; else by those rows
        if relu:
            dy = g.float() * (out > 0)
        else:
            dy = g.float() * _valid_rows(spec, g.device)[None, :, None]

        dx = dw = d_scale = d_offset = d_res = None
        if need_x:
            # the transpose of a flat conv is a flat conv: W'[t'] = W[k2-1-t']^T,
            # since the tap offsets negate under index reversal
            w_flip = (w_mat.detach().reshape(k2, c, -1).flip(0)
                      .transpose(1, 2).reshape(-1, c))
            dx = _dispatch(spec, False, (dy * scale.float()).to(x.dtype), w_flip,
                           torch.ones(c, dtype=torch.float32, device=x.device),
                           torch.zeros(c, dtype=torch.float32, device=x.device),
                           None, for_dx=True)
        if need_w or need_s:
            # per tap x_shift(t)^T dy against the UNSCALED dy, contracted over
            # every (batch, row) pair. dy is zero outside the pixel block, so
            # the products run over its rows [mb, mb + mp) alone (the shifted
            # rows stay inside the tensor: |off| <= lead <= mb). Operands in
            # x's dtype, f32 sums over the batch.
            lo, hi = spec.mb, spec.mb + spec.mp
            dyt = dy[:, lo:hi].to(x.dtype)
            dwt = torch.cat([
                torch.bmm(x[:, lo + off:hi + off].transpose(1, 2), dyt)
                .float().sum(0) for off in _tap_offsets(spec, k)], 0)
            if need_w:
                dw = (dwt * scale.float()).to(w_mat.dtype)
            if need_s:
                # d_scale_o = sum dy*acc = sum_{t,c} W[tc,o] * dWt[tc,o]: exact
                # for scale == 0, no division, no forward recompute
                d_scale = (w_mat.float() * dwt).sum(0)
        if need_o:
            d_offset = dy.sum((0, 1))
        if need_r:
            d_res = dy.to(residual.dtype)
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
