"""conv3x3: border pad -> 3x3 stride-1 conv -> +bias -> activation (NHWC).

Kernel 1 of the port, ``csrc/conv_block.cu``: the counterpart of the TPU
kernel ``scenedepthestimation_tpu/ops/pallas/conv_block.py::
conv3x3_elu_pallas``. :func:`conv3x3` launches it for a CUDA tensor and
takes :func:`conv3x3_plain` for a CPU tensor; there is no other route.

Borders: ``reflect`` (the reference's), ``edge`` and ``zero`` (the JAX
package's fast-border serving mode). Every H, W >= 1 is taken: reflect on
a 1-pixel axis repeats the pixel, as ``jnp.pad(mode="reflect")`` does.
The weight is in PyTorch's (Cout, Cin, 3, 3) layout, the JAX kernel's
(3, 3, Cin, Cout) transposed. The bf16 path with Cout > 1 runs on the
tensor cores and reads the weight as a slab arranged once
(:func:`arrange_slab`); callers that run a weight many times pass it in.
"""

from __future__ import annotations

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


def slab_shape(cin: int, cout: int) -> tuple:
    """(9, Cin rounded up to 16, Cout rounded up to 8): the tensor-core
    path's weight slab, as sde_conv3x3_arrange writes it."""
    return (9, -(-cin // 16) * 16, -(-cout // 8) * 8)


def arrange_slab_plain(weight: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> the slab: per tap ``t = ky * 3 + kx`` the K x N
    operand ``m[t, k, n] = weight[n, k, ky, kx]`` (zero past Cin and Cout)
    of the implicit GEMM, stored in the order the kernel's wgmma reads its B
    tiles: for each chunk of 16 input channels and group of 8 output
    channels, two 8 x 8 core matrices (k 0-7, then k 8-15), each 8 rows n
    of 8 contiguous k. Shape :func:`slab_shape`, elements in that order."""
    cout, cin = weight.shape[:2]
    _, cin_pad, cout_pad = slab_shape(cin, cout)
    m = weight.new_zeros((9, cin_pad, cout_pad))
    m[:, :cin, :cout] = weight.permute(2, 3, 1, 0).reshape(9, cin, cout)
    # (tap, kc, kb, k8, nb, n8) -> (tap, kc, nb, kb, n8, k8)
    m = m.reshape(9, cin_pad // 16, 2, 8, cout_pad // 8, 8).permute(0, 1, 4, 2, 5, 3)
    return m.contiguous().reshape(9, cin_pad, cout_pad)


def arrange_slab(weight: torch.Tensor) -> torch.Tensor:
    """The slab of a bf16 CUDA weight in one launch of the arrange kernel;
    :func:`arrange_slab_plain` for a CPU weight."""
    if weight.device.type == "cpu":
        return arrange_slab_plain(weight)
    if weight.dtype != torch.bfloat16 or not weight.is_contiguous() or weight.dim() != 4:
        raise TypeError("the slab is made from a contiguous bf16 (Cout, Cin, 3, 3) weight")
    cout, cin = weight.shape[:2]
    slab = torch.empty(slab_shape(cin, cout), dtype=weight.dtype, device=weight.device)
    err = _build.lib().sde_conv3x3_arrange(
        weight.data_ptr(), slab.data_ptr(), cin, cout, weight.device.index,
        _build.stream_of(weight),
    )
    _build.check(err, "conv3x3 slab")
    _build.LAUNCHES["conv3x3_slab"] += 1
    return slab


def uses_slab(x: torch.Tensor, cout: int) -> bool:
    """Whether the kernel reads a slab for this input: bf16 on CUDA, Cout > 1."""
    return x.device.type == "cuda" and x.dtype == torch.bfloat16 and cout > 1


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
    ``weight``, read by the bf16 path with Cout > 1; without it that path
    arranges one first. Anything else raises.
    """
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, bias, activation, border, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3 runs on cpu or cuda, not {x.device}")
    _check(x, weight, bias, activation, border)
    out_dtype = out_dtype or x.dtype
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv3x3 kernel takes float32 or bfloat16, not {x.dtype}")
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"out_dtype must be {x.dtype} or float32, not {out_dtype}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError(
                f"{name} must be {x.dtype} on {x.device}, got {t.dtype} on {t.device}"
            )
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"conv3x3 kernel needs a contiguous {name}")
    b, h, w, cin = x.shape
    cout = weight.shape[0]
    if uses_slab(x, cout):
        if slab is None:
            slab = arrange_slab(weight)
        if (tuple(slab.shape) != slab_shape(cin, cout) or slab.dtype != x.dtype
                or slab.device != x.device or not slab.is_contiguous()):
            raise ValueError(
                f"slab must be a contiguous {x.dtype} {slab_shape(cin, cout)} on "
                f"{x.device}, got {slab.dtype} {tuple(slab.shape)} on {slab.device}"
            )
    else:
        slab = None
    out = torch.empty((b, h, w, cout), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.lib()
    # Small grids split the input channels over more blocks, which add
    # their fp32 partial sums in a workspace.
    num_sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = lib.sde_conv3x3_splits(b, h, w, cin, cout, _DTYPES[x.dtype], num_sms)
    workspace = None
    if splits > 1:
        workspace = torch.empty(splits * out.numel(), dtype=torch.float32, device=x.device)
    err = lib.sde_conv3x3(
        x.data_ptr(), weight.data_ptr(), None if slab is None else slab.data_ptr(),
        bias.data_ptr(), out.data_ptr(),
        None if workspace is None else workspace.data_ptr(), splits,
        b, h, w, cin, cout,
        _DTYPES[x.dtype], int(out_dtype == torch.float32),
        ACTIVATIONS[activation], BORDERS[border],
        x.device.index, _build.stream_of(x),
    )
    _build.check(err, "conv3x3")
    _build.LAUNCHES["conv3x3"] += 1
    return out
