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
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

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
    does, then casts to ``out_dtype`` (default: x's dtype). The border is
    gathered by index (reflect, edge) or zero-padded. The sigmoid follows
    the TPU kernel, which applies it; the JAX ``conv3x3_xla`` returns the
    pre-activation for it. ``slab`` is the wrapper's argument, taken so
    that this function stands in for it, and not read: the weight is.
    """
    _check(x, weight, bias, activation, border)
    xf = x.float().permute(0, 3, 1, 2)
    if border == "zero":
        xp = F.pad(xf, (1, 1, 1, 1))
    else:
        h, w = xf.shape[2:]
        xp = xf.index_select(2, _border_rows(h, border, x.device))
        xp = xp.index_select(3, _border_rows(w, border, x.device))
    y = F.conv2d(xp, weight.float(), bias.float())
    y = _activate(y, activation)
    return y.permute(0, 2, 3, 1).to(out_dtype or x.dtype).contiguous()


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


# (device index, stream) -> [fp32 workspace, int32 counters] of the split
# calls: grown when a call needs more, then kept. Every call leaves the
# counters at 0; calls on one stream run one after another, so they share
# them safely.
_SCRATCH: dict = {}
_SCRATCH_LOCK = threading.Lock()


def _scratch(device: torch.device, stream: int, ws_elems: int, n_counters: int) -> tuple:
    with _SCRATCH_LOCK:
        store = _SCRATCH.setdefault((device.index, stream), [None, None])
        if ws_elems and (store[0] is None or store[0].numel() < ws_elems):
            store[0] = torch.empty(ws_elems, dtype=torch.float32, device=device)
        if n_counters and (store[1] is None or store[1].numel() < n_counters):
            store[1] = torch.zeros(n_counters, dtype=torch.int32, device=device)
        return tuple(store)


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
    Anything else raises.
    """
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
        _DTYPES[x.dtype], int(out_dtype == torch.float32),
        ACTIVATIONS[activation], BORDERS[border],
        dev.index, stream,
    )
    _build.check(err, "conv3x3")
    _build.LAUNCHES["conv3x3"] += 1
    return out
