"""conv3x3: border pad -> 3x3 stride-1 conv -> +bias -> activation (NHWC).

Kernel 1 of the port, ``csrc/conv_block.cu``: the counterpart of the TPU
kernel ``scenedepthestimation_tpu/ops/pallas/conv_block.py::
conv3x3_elu_pallas``. :func:`conv3x3` launches it for a CUDA tensor and
takes :func:`conv3x3_plain` for a CPU tensor; there is no other route.

Borders: ``reflect`` (the reference's), ``edge`` and ``zero`` (the JAX
package's fast-border serving mode). Every H, W >= 1 is taken: reflect on
a 1-pixel axis repeats the pixel, as ``jnp.pad(mode="reflect")`` does.
The weight is in PyTorch's (Cout, Cin, 3, 3) layout, the JAX kernel's
(3, 3, Cin, Cout) transposed. With Cout > 1 the kernel reads the weight as
a slab arranged once (:func:`arrange_slab`; the bf16 path's for the tensor
cores, the fp32 path's K-major); callers that run a weight many times pass
it in. Calls whose input channels are split reuse a workspace and counters
kept per device and stream (:func:`split_plan`).

The backward (:func:`conv3x3_backward`, fp32 or bf16, registered as the
op's autograd formula) is the kernels of ``csrc/conv3x3_bwd.cu`` and the
forward's own: :func:`conv3x3_dpre` writes dpre = grad * act'(out) once,
from the forward's output, into a scratch both gradients read (bf16:
rounded once); :func:`conv3x3_dx` runs the input's gradient as the
zero-bordered conv of dpre with the flipped, transposed weight (fp32: the
fp32 forward kernel on the slab :func:`arrange_dx_slab` makes each call;
bf16: ``conv3x3_dx_wgmma_kernel`` of ``csrc/conv3x3_dx_wgmma.cu`` on
:func:`arrange_dx_slab_bf16`'s slab, with the tiling :func:`dx_plan`
gives; the heads, Cout = 1, on a kernel of their own) and then folds the
border's gradient back onto the rows and columns it maps to (bf16: on the
tensor cores, added in fp32 and rounded again); :func:`conv3x3_dw` sums the
weight's and the bias's over strips of pixels, each block staging the
input's halo once for all nine taps (fp32 on the CUDA cores; bf16 on
``wgmma`` above 16 output channels, on ``mma.sync`` at 2-16 and, for the
heads, on the CUDA cores: :func:`dw_route`), split over the pixels and
added in a fixed order. They
replace the backward of the TPU kernel's custom VJP
(``scenedepthestimation_tpu/ops/pallas/conv_block.py::_fused_bwd``, XLA's
VJP of ``conv3x3_xla``) and of the JAX ``DispHead``'s conv and sigmoid.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from scenedepthestimation_tpu_torch.ops.cuda import _build

ACTIVATIONS = {"none": 0, "elu": 1, "relu": 2, "sigmoid": 3}
BORDERS = {"edge": 0, "reflect": 1, "zero": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _activate(y: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "elu":
        return F.elu(y)
    if activation == "relu":
        return F.relu(y)
    if activation == "sigmoid":
        return torch.sigmoid(y)
    return y


def _check(x, weight, bias, activation, border) -> None:
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if border not in BORDERS:
        raise ValueError(f"unknown border {border!r}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, Cin), got {tuple(x.shape)}")
    cin = x.shape[-1]
    if weight.dim() != 4 or tuple(weight.shape[1:]) != (cin, 3, 3):
        raise ValueError(
            f"weight must be (Cout, {cin}, 3, 3), got {tuple(weight.shape)}"
        )
    if bias.shape != (weight.shape[0],):
        raise ValueError(f"bias must be ({weight.shape[0]},), got {tuple(bias.shape)}")
    if x.shape[1] < 1 or x.shape[2] < 1:
        raise ValueError(f"conv3x3 needs H, W >= 1, got {tuple(x.shape)}")


def _border_rows(n: int, border: str, device) -> torch.Tensor:
    """Source index of each padded index -1 .. n: reflect maps -1 -> 1 and
    n -> n-2 (the pixel itself when n = 1), edge clamps."""
    i = torch.arange(-1, n + 1, device=device)
    if border == "reflect" and n > 1:
        i = torch.where(i < 0, -i, torch.where(i >= n, 2 * n - 2 - i, i))
    return i.clamp(0, n - 1)


def conv3x3_plain(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    activation: str = "elu",
    border: str = "reflect",
    out_dtype: Optional[torch.dtype] = None,
    slab: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version: x (B, H, W, Cin), weight (Cout, Cin, 3, 3),
    bias (Cout) -> act(conv3x3(pad(x)) + bias) as (B, H, W, Cout).

    Accumulates in fp32 and applies the activation in fp32, as the kernel
    does (float64 inputs: in float64), then casts to ``out_dtype`` (default:
    x's dtype). The border is
    gathered by index (reflect, edge) or zero-padded. The sigmoid follows
    the TPU kernel, which applies it; the JAX ``conv3x3_xla`` returns the
    pre-activation for it. ``slab`` is the wrapper's argument, taken so
    that this function stands in for it, and not read: the weight is.
    """
    _check(x, weight, bias, activation, border)
    acc = _acc_dtype(x)
    y = _activate(_conv_nchw(x.to(acc), weight.to(acc), bias.to(acc), border), activation)
    return y.permute(0, 2, 3, 1).to(out_dtype or x.dtype).contiguous()


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions' arithmetic type: fp32, or x's if wider (float64
    reference runs)."""
    return torch.promote_types(x.dtype, torch.float32)


def _conv_nchw(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
               border: str) -> torch.Tensor:
    """The bordered 3x3 conv of NHWC ``x``, as an NCHW view: the border
    gathered by index (reflect, edge) or zero-padded."""
    xf = x.permute(0, 3, 1, 2)
    if border == "zero":
        xp = F.pad(xf, (1, 1, 1, 1))
    else:
        h, w = xf.shape[2:]
        xp = xf.index_select(2, _border_rows(h, border, x.device))
        xp = xp.index_select(3, _border_rows(w, border, x.device))
    return F.conv2d(xp, weight, bias)


def _activation_grad(out: torch.Tensor, activation: str) -> torch.Tensor:
    """act'(pre) read from the activation's output: ELU 1 where out > 0,
    else out + 1 (= exp(pre)); ReLU 1 where out > 0; sigmoid out (1 - out);
    none 1."""
    if activation == "elu":
        return torch.where(out > 0, torch.ones_like(out), out + 1.0)
    if activation == "relu":
        return (out > 0).to(out.dtype)
    if activation == "sigmoid":
        return out * (1.0 - out)
    return torch.ones_like(out)


def conv3x3_backward_plain(
    grad: torch.Tensor,
    out: torch.Tensor,
    x: torch.Tensor,
    weight: torch.Tensor,
    activation: str = "elu",
    border: str = "reflect",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward: (dx, dweight, dbias) of
    :func:`conv3x3_plain` for the gradient ``grad`` of its output ``out``
    (B, H, W, Cout), with the forward's ``x`` and ``weight``. dpre =
    grad * act'(out) (:func:`_activation_grad`); dx and dweight are
    autograd's of the bordered conv (the index gather's backward folds the
    border back), dbias the sum of dpre. In fp32 (or x's wider type),
    returned in x's, the weight's and the weight's dtypes.

    bf16 x and weight (grad and out bf16, or fp32 for the heads) take the
    kernels' rounding points: dpre is rounded to bf16 once (as JAX's
    cotangent of a bf16 conv is), dx is :func:`conv3x3_dx_plain` (the
    interior rounded once, the border's fold added in fp32 and rounded
    again), dweight and dbias are fp32 sums rounded once."""
    if x.dtype == torch.bfloat16:
        dpre = conv3x3_dpre_plain(grad, out, activation).to(torch.bfloat16)
        return (conv3x3_dx_plain(dpre, weight, border),) + conv3x3_dw_plain(dpre, x, border)
    acc = _acc_dtype(x)
    dpre = conv3x3_dpre_plain(grad, out, activation).to(acc)
    with torch.enable_grad():
        xl = x.detach().to(acc).requires_grad_()
        wl = weight.detach().to(acc).requires_grad_()
        y = _conv_nchw(xl, wl, None, border)
        dx, dw = torch.autograd.grad(y, (xl, wl), dpre.permute(0, 3, 1, 2))
    db = dpre.sum(dim=(0, 1, 2))
    return dx.to(x.dtype), dw.to(weight.dtype), db.to(weight.dtype)


def slab_shape(cin: int, cout: int, dtype: torch.dtype) -> tuple:
    """The kernel's weight slab for ``dtype``, as sde_conv3x3_arrange writes
    it: float32 (9, Cin rounded up to 8, Cout rounded up to 4); otherwise
    the tensor-core path's (9, Cin rounded up to 16, Cout rounded up to 8)."""
    if dtype == torch.float32:
        return (9, -(-cin // 8) * 8, -(-cout // 4) * 4)
    return (9, -(-cin // 16) * 16, -(-cout // 8) * 8)


def arrange_slab_plain(weight: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> the slab of the weight's dtype (shape
    :func:`slab_shape`): per tap ``t = ky * 3 + kx`` the K x N operand
    ``m[t, k, n] = weight[n, k, ky, kx]`` (zero past Cin and Cout) of the
    implicit GEMM. float32 keeps it so, K-major: the fp32 kernel reads each
    (tap, k) row of N as 16-byte vectors. Other dtypes store it in the order
    the tensor-core kernel's wgmma reads its B tiles: for each chunk of 16
    input channels and group of 8 output channels, two 8 x 8 core matrices
    (k 0-7, then k 8-15), each 8 rows n of 8 contiguous k."""
    cout, cin = weight.shape[:2]
    _, cin_pad, cout_pad = slab_shape(cin, cout, weight.dtype)
    m = weight.new_zeros((9, cin_pad, cout_pad))
    m[:, :cin, :cout] = weight.permute(2, 3, 1, 0).reshape(9, cin, cout)
    if weight.dtype == torch.float32:
        return m
    # (tap, kc, kb, k8, nb, n8) -> (tap, kc, nb, kb, n8, k8)
    m = m.reshape(9, cin_pad // 16, 2, 8, cout_pad // 8, 8).permute(0, 1, 4, 2, 5, 3)
    return m.contiguous().reshape(9, cin_pad, cout_pad)


def arrange_slab(weight: torch.Tensor) -> torch.Tensor:
    """The slab of a float32 or bf16 CUDA weight in one launch of the
    arrange kernel; :func:`arrange_slab_plain` for a CPU weight."""
    if weight.device.type == "cpu":
        return arrange_slab_plain(weight)
    if weight.dtype not in _DTYPES or not weight.is_contiguous() or weight.dim() != 4:
        raise TypeError(
            "the slab is made from a contiguous float32 or bf16 (Cout, Cin, 3, 3) weight"
        )
    cout, cin = weight.shape[:2]
    slab = torch.empty(slab_shape(cin, cout, weight.dtype), dtype=weight.dtype,
                       device=weight.device)
    err = _build.lib().sde_conv3x3_arrange(
        weight.data_ptr(), slab.data_ptr(), cin, cout, _DTYPES[weight.dtype],
        weight.device.index, _build.stream_of(weight),
    )
    _build.check(err, "conv3x3 slab")
    _build.LAUNCHES["conv3x3_slab"] += 1
    return slab


def uses_slab(x: torch.Tensor, cout: int) -> bool:
    """Whether the kernel reads a slab for this input: float32 or bf16 on
    CUDA, Cout > 1."""
    return x.device.type == "cuda" and x.dtype in _DTYPES and cout > 1


@functools.lru_cache(maxsize=None)
def split_plan(b: int, h: int, w: int, cin: int, cout: int, dtype: torch.dtype,
               device_index: int) -> tuple:
    """(input-channel slices, fp32 workspace elements, int32 counters) of a
    kernel call at this shape on CUDA device ``device_index``, from
    sde_conv3x3_plan (which asks the runtime for the SM count and the
    kernels' occupancy once per device)."""
    plan = (ctypes.c_longlong * 3)()
    err = _build.lib().sde_conv3x3_plan(b, h, w, cin, cout, _DTYPES[dtype], device_index, plan)
    _build.check(err, "conv3x3 plan")
    return tuple(plan)


# (device index, stream) -> [fp32 workspace, int32 counters, fp32 dpre, fp32
# zeros, bf16 dpre, bf16 zeros]: the split calls' workspace and counters,
# which the dW kernel's workspace shares; the backward's dpre; a zero bias
# for the input gradient's conv.
# Each is grown when a call needs more, then kept. Every call leaves the
# counters at 0; calls on one stream run one after another, so they share
# them safely.
_SCRATCH: dict = {}
_SCRATCH_LOCK = threading.Lock()


def _kept(device: torch.device, stream: int, slot: int, elems: int,
          dtype: torch.dtype = torch.float32, zeros: bool = False) -> Optional[torch.Tensor]:
    """Slot ``slot`` of the store of (device, stream), at least ``elems``
    long (None while no call has needed it)."""
    with _SCRATCH_LOCK:
        store = _SCRATCH.setdefault((device.index, stream), [None] * 6)
        if elems and (store[slot] is None or store[slot].numel() < elems):
            store[slot] = (torch.zeros if zeros else torch.empty)(elems, dtype=dtype,
                                                                 device=device)
        return store[slot]


def _scratch(device: torch.device, stream: int, ws_elems: int, n_counters: int) -> tuple:
    return (_kept(device, stream, 0, ws_elems),
            _kept(device, stream, 1, n_counters, torch.int32, zeros=True))


def _launch(x: torch.Tensor, weight: torch.Tensor, slab: Optional[torch.Tensor],
            bias: torch.Tensor, out: torch.Tensor, activation: str, border: str) -> None:
    """One sde_conv3x3 call into ``out`` on x's stream, with the split
    workspace and counters of the (device, stream)."""
    dev = x.device
    b, h, w, cin = x.shape
    cout = out.shape[-1]
    stream = _build.stream_of(x)
    _, ws_elems, n_counters = split_plan(b, h, w, cin, cout, x.dtype, dev.index)
    workspace, counters = _scratch(dev, stream, ws_elems, n_counters)
    err = _build.lib().sde_conv3x3(
        x.data_ptr(), weight.data_ptr(), None if slab is None else slab.data_ptr(),
        bias.data_ptr(), out.data_ptr(),
        None if workspace is None else workspace.data_ptr(),
        0 if workspace is None else workspace.numel(),
        None if counters is None else counters.data_ptr(),
        0 if counters is None else counters.numel(),
        b, h, w, cin, cout,
        _DTYPES[x.dtype], int(out.dtype == torch.float32),
        ACTIVATIONS[activation], BORDERS[border],
        dev.index, stream,
    )
    _build.check(err, "conv3x3")


def _conv3x3(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    activation: str = "elu",
    border: str = "reflect",
    out_dtype: Optional[torch.dtype] = None,
    slab: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The body of :func:`conv3x3`, and the implementation of its op."""
    dev = x.device
    if dev.type == "cpu":
        return conv3x3_plain(x, weight, bias, activation, border, out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"conv3x3 runs on cpu or cuda, not {dev}")
    _check(x, weight, bias, activation, border)
    out_dtype = out_dtype or x.dtype
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv3x3 kernel takes float32 or bfloat16, not {x.dtype}")
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"out_dtype must be {x.dtype} or float32, not {out_dtype}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.device != dev or t.dtype != x.dtype:
            raise TypeError(f"{name} must be {x.dtype} on {dev}, got {t.dtype} on {t.device}")
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"conv3x3 kernel needs a contiguous {name}")
    b, h, w, cin = x.shape
    cout = weight.shape[0]
    if cout > 1:
        if slab is None:
            slab = arrange_slab(weight)
        want = slab_shape(cin, cout, x.dtype)
        if (tuple(slab.shape) != want or slab.dtype != x.dtype
                or slab.device != dev or not slab.is_contiguous()):
            raise ValueError(
                f"slab must be a contiguous {x.dtype} {want} on {dev}, got "
                f"{slab.dtype} {tuple(slab.shape)} on {slab.device}"
            )
    else:
        slab = None
    out = torch.empty((b, h, w, cout), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    _launch(x, weight, slab, bias, out, activation, border)
    _build.LAUNCHES["conv3x3"] += 1
    return out


def _conv3x3_fake(x, weight, bias, activation, border, out_dtype, slab):
    return x.new_empty(tuple(x.shape[:3]) + (weight.shape[0],), dtype=out_dtype or x.dtype)


conv3x3_op = _build.register_op(
    "conv3x3",
    "(Tensor x, Tensor weight, Tensor bias, str activation, str border, "
    "ScalarType? out_dtype, Tensor? slab) -> Tensor",
    _conv3x3, _conv3x3_fake,
)


def conv3x3_dpre_plain(grad: torch.Tensor, out: torch.Tensor,
                       activation: str = "elu") -> torch.Tensor:
    """dpre = grad * act'(out) (:func:`_activation_grad`), in fp32 or the
    inputs' wider type."""
    acc = _acc_dtype(grad)
    return grad.to(acc) * _activation_grad(out.to(acc), activation)


def _check_bwd(name: str, dtypes, **tensors) -> torch.device:
    """The device of ``tensors``: CUDA, each on it, contiguous, of a dtype in
    ``dtypes``; raises otherwise."""
    dev = next(iter(tensors.values())).device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
    for k, t in tensors.items():
        if t.dtype not in dtypes or t.device != dev:
            raise TypeError(f"{name} takes {names} on {dev}; {k} is {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs a contiguous {k}")
    return dev


def _same_dtype(name: str, *tensors: torch.Tensor) -> None:
    if len({t.dtype for t in tensors}) != 1:
        raise TypeError(f"{name} takes one dtype, got {[t.dtype for t in tensors]}")


# dpre's dtype for the dtype of grad and out: the kernel's three routes.
_DPRE_ROUTES = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                (torch.float32, torch.bfloat16)}


def conv3x3_dpre(grad: torch.Tensor, out: torch.Tensor, activation: str = "elu",
                 dpre: Optional[torch.Tensor] = None,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """dpre = grad * act'(out), computed in fp32 and stored in ``dtype``
    (default: ``dpre``'s when given, else grad's): the dpre kernel on CUDA
    (into ``dpre``, a tensor of grad's shape, when given; grad and out fp32
    -> fp32, bf16 -> bf16, fp32 -> bf16 for a bf16 network's heads),
    :func:`conv3x3_dpre_plain` rounded to ``dtype`` on the CPU."""
    dtype = dtype or (dpre.dtype if dpre is not None else grad.dtype)
    if grad.device.type == "cpu":
        return conv3x3_dpre_plain(grad, out, activation).to(dtype)
    dev = _check_bwd("conv3x3_dpre", tuple(_DTYPES), grad=grad, out=out)
    _same_dtype("conv3x3_dpre", grad, out)
    if (grad.dtype, dtype) not in _DPRE_ROUTES:
        raise TypeError(f"conv3x3_dpre has no route from {grad.dtype} to {dtype}")
    if out.shape != grad.shape:
        raise ValueError(f"grad {tuple(grad.shape)} is not the output's {tuple(out.shape)}")
    if dpre is None:
        dpre = torch.empty(grad.shape, dtype=dtype, device=dev)
    _check_bwd("conv3x3_dpre", (dtype,), dpre=dpre)
    if dpre.shape != grad.shape:
        raise ValueError(f"dpre {tuple(dpre.shape)} is not grad's {tuple(grad.shape)}")
    err = _build.lib().sde_conv3x3_bwd_dpre(grad.data_ptr(), out.data_ptr(), dpre.data_ptr(),
                                            grad.numel(), ACTIVATIONS[activation],
                                            _DTYPES[grad.dtype], _DTYPES[dtype], dev.index,
                                            _build.stream_of(grad))
    _build.check(err, "conv3x3_dpre")
    _build.LAUNCHES["conv3x3_dpre"] += 1
    return dpre


def flip_weight(weight: torch.Tensor) -> torch.Tensor:
    """w'[ci, co, ky, kx] = w[co, ci, 2 - ky, 2 - kx]: the weight whose
    zero-bordered conv of dpre is the input's gradient inside the image (a
    view)."""
    return weight.flip((2, 3)).transpose(0, 1)


def arrange_dx_slab_plain(weight: torch.Tensor) -> torch.Tensor:
    """The fp32 forward's K-major slab of :func:`flip_weight` of ``weight``
    (Cout, Cin, 3, 3), in the weight's dtype: (9, Cout rounded up to 8, Cin
    rounded up to 4), ``m[t, co, ci] = weight[co, ci, 8 - t]`` (taps
    flattened), zero past Cout and Cin."""
    cout, cin = weight.shape[:2]
    _, kp, np_ = slab_shape(cout, cin, torch.float32)
    m = weight.new_zeros((9, kp, np_))
    m[:, :cout, :cin] = weight.flip((2, 3)).permute(2, 3, 0, 1).reshape(9, cout, cin)
    return m


def arrange_dx_slab(weight: torch.Tensor) -> torch.Tensor:
    """:func:`arrange_dx_slab_plain` of a float32 CUDA weight in one launch
    of the slab kernel; the plain version for a CPU weight."""
    if weight.device.type == "cpu":
        return arrange_dx_slab_plain(weight)
    dev = _check_bwd("conv3x3_dx_slab", (torch.float32,), weight=weight)
    cout, cin = weight.shape[:2]
    _, kp, np_ = slab_shape(cout, cin, torch.float32)
    slab = torch.empty((9, kp, np_), dtype=torch.float32, device=dev)
    err = _build.lib().sde_conv3x3_bwd_slab(weight.data_ptr(), slab.data_ptr(), cin, cout,
                                            dev.index, _build.stream_of(weight))
    _build.check(err, "conv3x3_dx_slab")
    _build.LAUNCHES["conv3x3_dx_slab"] += 1
    return slab


def arrange_dx_slab_bf16_plain(weight: torch.Tensor) -> torch.Tensor:
    """The slab a bf16 dx reads (the interior's ``wgmma`` and the fold's
    ``mma.sync``), from a bf16 weight (Cout, Cin, 3, 3): the tensor-core
    forward's slab of :func:`flip_weight` of it, :func:`arrange_slab_plain`'s
    core-matrix order, shape ``slab_shape(Cout, Cin, bf16)``."""
    return arrange_slab_plain(flip_weight(weight).contiguous())


def arrange_dx_slab_bf16(weight: torch.Tensor) -> torch.Tensor:
    """:func:`arrange_dx_slab_bf16_plain` of a bf16 CUDA weight in one launch
    of the bf16 slab kernel; the plain version for a CPU weight."""
    if weight.device.type == "cpu":
        return arrange_dx_slab_bf16_plain(weight)
    dev = _check_bwd("conv3x3_dx_slab", (torch.bfloat16,), weight=weight)
    cout, cin = weight.shape[:2]
    slab = torch.empty(slab_shape(cout, cin, torch.bfloat16), dtype=torch.bfloat16, device=dev)
    err = _build.lib().sde_conv3x3_bwd_slab_bf16(weight.data_ptr(), slab.data_ptr(), cin, cout,
                                                 dev.index, _build.stream_of(weight))
    _build.check(err, "conv3x3_dx_slab")
    _build.LAUNCHES["conv3x3_dx_slab"] += 1
    return slab


def conv3x3_dx_fold_plain(dpre: torch.Tensor, weight: torch.Tensor,
                          border: str = "reflect") -> torch.Tensor:
    """What the border adds to the input's gradient (B, H, W, Cin), zero
    under the zero border: the gradient of the padded input's border rows
    -1 and H and columns -1 and W (the transposed conv of dpre, corners
    included), added onto the rows and columns they map to."""
    b, h, w, _ = dpre.shape
    cin = weight.shape[1]
    acc = _acc_dtype(dpre)
    if border == "zero":
        return dpre.new_zeros((b, h, w, cin), dtype=acc)
    g = F.conv_transpose2d(dpre.to(acc).permute(0, 3, 1, 2), weight.to(acc))
    g[:, :, 1:h + 1, 1:w + 1] = 0
    g = g.new_zeros((b, cin, h, w + 2)).index_add_(2, _border_rows(h, border, dpre.device), g)
    g = g.new_zeros((b, cin, h, w)).index_add_(3, _border_rows(w, border, dpre.device), g)
    return g.permute(0, 2, 3, 1)


def conv3x3_dx_plain(dpre: torch.Tensor, weight: torch.Tensor,
                     border: str = "reflect") -> torch.Tensor:
    """The input's gradient (B, H, W, Cin) as the kernels compute it: the
    zero-bordered conv of dpre with :func:`flip_weight` (no bias, no
    activation) plus :func:`conv3x3_dx_fold_plain`, in fp32 or dpre's wider
    type. A bf16 dpre gives bf16 with the kernels' two roundings: the
    interior's fp32 sum rounded once, then the fold added to it in fp32 and
    rounded again (JAX's transposed conv rounds, then the pad's VJP adds in
    bf16)."""
    acc = _acc_dtype(dpre)
    wt = flip_weight(weight.to(acc))
    interior = conv3x3_plain(dpre.to(acc), wt, wt.new_zeros(wt.shape[0]), "none", "zero")
    if dpre.dtype != torch.bfloat16:
        return interior + conv3x3_dx_fold_plain(dpre, weight, border)
    interior = interior.to(torch.bfloat16)
    if border == "zero":
        return interior
    return (interior.float() + conv3x3_dx_fold_plain(dpre, weight, border)).to(torch.bfloat16)


# The bf16 interior kernel (csrc/conv3x3_dx_wgmma.cu): its pixel tile's
# rows and columns by the number of warpgroups (each an 8 x 8 quadrant, an
# m64 tile: w' resident, 2 warpgroups and two blocks an SM; streamed, 4 and
# one), the dpre channels of a step, its stages, and the shared memory a
# block may take by the number of warpgroups.
DX_TILES = {2: (8, 16), 4: (16, 16)}
DX_STEP = 16
DX_STAGES = 4
_DX_SMEM = {2: 115712, 4: 232448}


def dx_halo_pixels(wgs: int) -> int:
    """The interior kernel's halo pixels a channel group: the tile's rows and
    columns plus 2 each, rounded up to one past a multiple of 8."""
    rows, cols = DX_TILES[wgs]
    return ((rows + 2) * (cols + 2) + 7) // 8 * 8 + 1


def _dx_bytes(tn: int, kc: int, resident: bool) -> int:
    """Shared memory of the interior kernel: w' (resident: 9 x kc steps x tn
    x 16; streamed: a step's 9 x tn x 16 a stage) and a halo of two channel
    groups a stage."""
    halo = 2 * dx_halo_pixels(2 if resident else 4) * 8
    b = 9 * tn * DX_STEP
    return 2 * (kc * b + DX_STAGES * halo if resident else DX_STAGES * (b + halo))


@functools.lru_cache(maxsize=None)
def dx_plan(cin: int, cout: int) -> tuple:
    """(N tile, w' resident, shared bytes) of the bf16 interior kernel
    ``conv3x3_dx_wgmma_kernel`` for dx's Cin output channels and dpre's Cout
    (K = 9 Cout): the tile of 16, 32, 64 or 128 channels that covers Cin
    (128 above 64), halved once, where w' for the whole of K fits beside
    the pipeline of a block of two warpgroups (two blocks an SM); where it
    fits at neither, w' streams with the halo through blocks of four
    warpgroups (one an SM) at 64 channels (Cin <= 64) or 128.
    csrc/conv3x3_dx_wgmma.cu's dx_wgmma_plan takes the same steps."""
    kc = -(-cout // DX_STEP)
    tn = 16 if cin <= 16 else 32 if cin <= 32 else 64 if cin <= 64 else 128
    for t in (tn, tn // 2):
        if t >= 16 and _dx_bytes(t, kc, True) <= _DX_SMEM[2]:
            return t, True, _dx_bytes(t, kc, True)
    t = 64 if tn <= 64 else 128
    return t, False, _dx_bytes(t, kc, False)


def conv3x3_dx(dpre: torch.Tensor, weight: torch.Tensor, border: str = "reflect") -> torch.Tensor:
    """The input's gradient from dpre (B, H, W, Cout) and the forward's weight
    (Cout, Cin, 3, 3), both fp32 or both bf16, in their dtype. On CUDA: the
    slab of w' (one launch, when read; bf16: the tensor-core slab, which the
    interior and the fold both read), the interior (fp32: ``conv3x3_f32_kernel`` on
    dpre with that slab; bf16: ``conv3x3_dx_wgmma_kernel``, persistent blocks
    on ``wgmma`` with the tile :func:`dx_plan` gives; Cin = 1 the forward's
    head kernel on w'; Cout = 1 the heads' dx kernel), then the fold under
    the reflect and edge borders (fp32 on the CUDA cores, bf16 on
    ``mma.sync`` from the tensor-core slab of w'). :func:`conv3x3_dx_plain`
    on the CPU. Launches count as ``conv3x3_dx`` (fp32), ``conv3x3_dx_bf16``
    (the bf16 interior kernel), ``conv3x3_dx_bf16_head`` (Cout = 1) and
    ``conv3x3_dx_bf16_cin1`` (Cin = 1); the folds as ``conv3x3_dx_fold`` and
    ``conv3x3_dx_fold_bf16``."""
    if dpre.device.type == "cpu":
        return conv3x3_dx_plain(dpre, weight, border)
    dev = _check_bwd("conv3x3_dx", tuple(_DTYPES), dpre=dpre, weight=weight)
    _same_dtype("conv3x3_dx", dpre, weight)
    if border not in BORDERS:
        raise ValueError(f"unknown border {border!r}")
    b, h, w, cout = dpre.shape
    cin = weight.shape[1]
    if tuple(weight.shape) != (cout, cin, 3, 3):
        raise ValueError(f"weight {tuple(weight.shape)} does not match dpre {tuple(dpre.shape)}")
    dx = torch.empty((b, h, w, cin), dtype=dpre.dtype, device=dev)
    if dx.numel() == 0:
        return dx
    stream = _build.stream_of(dpre)
    bf16 = dpre.dtype == torch.bfloat16
    if bf16:
        slab = arrange_dx_slab_bf16(weight) if border != "zero" or min(cin, cout) > 1 else None
    else:
        slab = arrange_dx_slab(weight) if border != "zero" or min(cin, cout) > 1 else None
    if cout == 1:
        err = _build.lib().sde_conv3x3_bwd_dx_head(dpre.data_ptr(), weight.data_ptr(),
                                                   dx.data_ptr(), b, h, w, cin,
                                                   _DTYPES[dpre.dtype], dev.index, stream)
        _build.check(err, "conv3x3_dx")
        route = "conv3x3_dx_bf16_head" if bf16 else "conv3x3_dx"
    elif bf16 and cin > 1:
        err = _build.lib().sde_conv3x3_bwd_dx_bf16(dpre.data_ptr(), slab.data_ptr(),
                                                   dx.data_ptr(), b, h, w, cin, cout, dev.index,
                                                   stream)
        _build.check(err, "conv3x3_dx")
        route = "conv3x3_dx_bf16"
    else:
        # fp32 runs the interior on the fp32 forward's kernel; with Cin = 1
        # the forward's head kernel runs it, reading the weight (1, Cout, 3,
        # 3) itself, not a slab.
        wt = flip_weight(weight).contiguous() if cin == 1 else weight
        zero = _kept(dev, stream, 5 if bf16 else 3, cin, dpre.dtype, zeros=True)[:cin]
        _launch(dpre, wt, slab if cin > 1 else None, zero, dx, "none", "zero")
        route = "conv3x3_dx_bf16_cin1" if bf16 else "conv3x3_dx"
    _build.LAUNCHES[route] += 1
    if border != "zero" and bf16:
        err = _build.lib().sde_conv3x3_bwd_fold_bf16(dpre.data_ptr(), slab.data_ptr(),
                                                     dx.data_ptr(), b, h, w, cin, cout,
                                                     BORDERS[border], dev.index, stream)
        _build.check(err, "conv3x3_dx_fold")
        _build.LAUNCHES["conv3x3_dx_fold_bf16"] += 1
    elif border != "zero":
        err = _build.lib().sde_conv3x3_bwd_fold(dpre.data_ptr(), slab.data_ptr(),
                                                dx.data_ptr(), b, h, w, cin, cout,
                                                BORDERS[border], _DTYPES[dpre.dtype], dev.index,
                                                stream)
        _build.check(err, "conv3x3_dx_fold")
        _build.LAUNCHES["conv3x3_dx_fold"] += 1
    return dx


# The dW kernels, by plan[3] of :func:`bwd_plan`, and the name their
# launches count under.
DW_KERNELS = ("conv3x3_dw", "conv3x3_dw_bf16_mma", "conv3x3_dw_bf16", "conv3x3_dw_bf16_head")


def dw_route(cin: int, cout: int, dtype: torch.dtype) -> int:
    """The dW kernel of a shape (an index into :data:`DW_KERNELS`): fp32 the
    CUDA-core ``conv3x3_dw_kernel``; bf16 with Cout > 16
    ``conv3x3_dw_wgmma_kernel`` (64 output channels a block on ``wgmma``),
    the heads (Cout = 1) ``conv3x3_dw_head_kernel`` (CUDA cores, a channel
    pair a thread sliding its 3 x 3 window along a strip row), 2-16 output
    channels ``conv3x3_dw_tc_kernel`` (``mma.sync``: its 16-row tiles waste
    no rows there). csrc/conv3x3_bwd.cu's dw_bf16_route takes the same
    choice."""
    if dtype == torch.float32:
        return 0
    return 2 if cout > 16 else 3 if cout == 1 else 1


@functools.lru_cache(maxsize=None)
def bwd_plan(b: int, h: int, w: int, cin: int, cout: int, dtype: torch.dtype,
             device_index: int) -> tuple:
    """(slices, fp32 workspace elements, strips a slice, kernel) of the dW
    kernel for ``dtype`` at this shape on CUDA device ``device_index``, from
    sde_conv3x3_bwd_plan; the kernel as :func:`dw_route` gives it."""
    plan = (ctypes.c_longlong * 4)()
    err = _build.lib().sde_conv3x3_bwd_plan(b, h, w, cin, cout, _DTYPES[dtype], device_index,
                                            plan)
    _build.check(err, "conv3x3 backward plan")
    return tuple(plan)


def conv3x3_dw_plain(dpre: torch.Tensor, x: torch.Tensor,
                     border: str = "reflect") -> Tuple[torch.Tensor, torch.Tensor]:
    """(dweight (Cout, Cin, 3, 3), dbias (Cout)) from dpre (B, H, W, Cout)
    and the forward's input x: autograd of the bordered conv for the
    weight, the sum of dpre for the bias; in fp32 or x's wider type, and
    for a bf16 x those fp32 sums rounded to bf16 once."""
    acc = _acc_dtype(x)
    cout, cin = dpre.shape[-1], x.shape[-1]
    with torch.enable_grad():
        wl = torch.zeros((cout, cin, 3, 3), dtype=acc, device=x.device, requires_grad=True)
        y = _conv_nchw(x.detach().to(acc), wl, None, border)
        (dw,) = torch.autograd.grad(y, wl, dpre.to(acc).permute(0, 3, 1, 2))
    db = dpre.to(acc).sum(dim=(0, 1, 2))
    if x.dtype == torch.bfloat16:
        return dw.to(torch.bfloat16), db.to(torch.bfloat16)
    return dw, db


def conv3x3_dw(dpre: torch.Tensor, x: torch.Tensor,
               border: str = "reflect") -> Tuple[torch.Tensor, torch.Tensor]:
    """(dweight, dbias) from dpre and the forward's input, both fp32 or both
    bf16, in their dtype: on CUDA the dW kernel :func:`dw_route` picks
    (fp32: CUDA cores; bf16: the tensor cores, ``wgmma`` or ``mma.sync``,
    or the heads' CUDA-core kernel; fp32 sums rounded once) and its reduce (the workspace kept per device
    and stream), :func:`conv3x3_dw_plain` on the CPU. A call counts one
    launch under the kernel's name in :data:`DW_KERNELS`."""
    if x.device.type == "cpu":
        return conv3x3_dw_plain(dpre, x, border)
    dev = _check_bwd("conv3x3_dw", tuple(_DTYPES), dpre=dpre, x=x)
    _same_dtype("conv3x3_dw", dpre, x)
    if border not in BORDERS:
        raise ValueError(f"unknown border {border!r}")
    b, h, w, cin = x.shape
    cout = dpre.shape[-1]
    if tuple(dpre.shape[:3]) != (b, h, w):
        raise ValueError(f"dpre {tuple(dpre.shape)} does not match x {tuple(x.shape)}")
    dw = torch.empty((cout, cin, 3, 3), dtype=x.dtype, device=dev)
    db = torch.empty((cout,), dtype=x.dtype, device=dev)
    if x.numel() == 0 or cout == 0:
        return dw.zero_(), db.zero_()
    stream = _build.stream_of(x)
    _, ws_elems, _, route = bwd_plan(b, h, w, cin, cout, x.dtype, dev.index)
    ws = _kept(dev, stream, 0, ws_elems)
    err = _build.lib().sde_conv3x3_bwd_dw(
        dpre.data_ptr(), x.data_ptr(), dw.data_ptr(), db.data_ptr(), ws.data_ptr(), ws.numel(),
        b, h, w, cin, cout, BORDERS[border], _DTYPES[x.dtype], dev.index, stream)
    _build.check(err, "conv3x3_dw")
    _build.LAUNCHES[DW_KERNELS[route]] += 1
    return dw, db


def conv3x3_backward(
    grad: torch.Tensor,
    out: torch.Tensor,
    x: torch.Tensor,
    weight: torch.Tensor,
    activation: str = "elu",
    border: str = "reflect",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dweight, dbias) for the gradient ``grad`` of :func:`conv3x3`'s
    output ``out``: on CUDA :func:`conv3x3_dpre` into the (device, stream)'s
    kept scratch, then :func:`conv3x3_dx` and :func:`conv3x3_dw` (``grad``
    made contiguous first, a copy only when it is not); on the CPU
    :func:`conv3x3_backward_plain`. The kernels take float32 throughout, or
    bf16 x and weight with bf16 grad and out (or float32 ones: the heads'
    sigmoid output) and then return bf16 with dpre rounded to bf16 once.
    Anything else raises."""
    if x.device.type == "cpu":
        return conv3x3_backward_plain(grad, out, x, weight, activation, border)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3's backward runs on cpu or cuda, not {x.device}")
    if activation not in ACTIVATIONS or border not in BORDERS:
        raise ValueError(f"unknown activation {activation!r} or border {border!r}")
    bf16 = x.dtype == torch.bfloat16
    grad_dtypes = (torch.bfloat16, torch.float32) if bf16 else (torch.float32,)
    for name, t, dtypes in (("grad", grad, grad_dtypes), ("out", out, (grad.dtype,)),
                            ("x", x, (torch.float32, torch.bfloat16)),
                            ("weight", weight, (x.dtype,))):
        if t.dtype not in dtypes or t.device != x.device:
            raise TypeError(f"conv3x3's backward kernels take float32 throughout, or bfloat16 x "
                            f"and weight with bfloat16 or float32 grad and out, on {x.device}; "
                            f"{name} is {t.dtype} on {t.device}")
    b, h, w, cin = x.shape
    cout = weight.shape[0]
    if tuple(weight.shape) != (cout, cin, 3, 3) or tuple(out.shape) != (b, h, w, cout):
        raise ValueError(f"conv3x3 backward: x {tuple(x.shape)}, weight {tuple(weight.shape)}, "
                         f"out {tuple(out.shape)} do not match")
    if tuple(grad.shape) != tuple(out.shape):
        raise ValueError(f"grad {tuple(grad.shape)} is not the output's {tuple(out.shape)}")
    grad, out, x, weight = (t.contiguous() for t in (grad, out, x, weight))
    if x.numel() == 0:
        return torch.zeros_like(x), torch.zeros_like(weight), weight.new_zeros((cout,))
    scratch = _kept(x.device, _build.stream_of(x), 4 if bf16 else 2, grad.numel(), x.dtype)
    dpre = conv3x3_dpre(grad, out, activation, scratch[:grad.numel()].view(grad.shape))
    dx = conv3x3_dx(dpre, weight, border)
    dw, db = conv3x3_dw(dpre, x, border)
    return dx, dw, db


def _setup_context(ctx, inputs, output):
    x, weight, _, activation, border, _, _ = inputs
    ctx.save_for_backward(x, weight, output)
    ctx.activation, ctx.border = activation, border


def _backward(ctx, grad):
    x, weight, out = ctx.saved_tensors
    dx, dw, db = conv3x3_backward(grad, out, x, weight, ctx.activation, ctx.border)
    return dx, dw, db, None, None, None, None


conv3x3_op.register_autograd(_backward, setup_context=_setup_context)


def conv3x3(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    activation: str = "elu",
    border: str = "reflect",
    out_dtype: Optional[torch.dtype] = None,
    slab: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The conv3x3 kernel on a CUDA tensor, its plain version on a CPU one.

    Same contract as :func:`conv3x3_plain`. On CUDA, x, weight and bias
    must be contiguous and of one dtype (float32 or bfloat16); out_dtype
    is x's dtype or float32. ``slab`` is :func:`arrange_slab` of
    ``weight``, read with Cout > 1; without it the call arranges one first.
    Anything else raises. A call that autograd records goes through the
    op, whose backward is :func:`conv3x3_backward`; the slab is the
    weight's detached copy and gets no gradient.
    """
    if _build.tracing or _build.needs_grad(x, weight, bias):
        return conv3x3_op(x, weight, bias, activation, border, out_dtype, slab)
    return _conv3x3(x, weight, bias, activation, border, out_dtype, slab)
