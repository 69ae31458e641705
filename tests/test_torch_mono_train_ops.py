"""The mono training ops of the PyTorch port (scenedepthestimation_tpu_torch)
against their JAX counterparts on the same inputs, made with numpy from a
seed: conv3x3's backward (held to ``jax.vjp`` of the JAX conv), BatchNorm in
train mode (held to Flax's ``nn.BatchNorm``), the mono supervised loss, the
GT encoding and the mono augmentation (the transform given JAX's own
draws); and the training route through the decoder: the conv3x3 op with
its backward, the kept slab following the weights, the fused tail kept
off a recorded forward.

The port's wrappers take their plain versions here: every tensor lies on
the CPU. The CUDA backward kernels are held to those plain versions on the
card by chip_smoke.py (phase 21).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from torch_threads import two_threads  # noqa: F401 (autouse)

from scenedepthestimation_tpu import losses as jax_losses
from scenedepthestimation_tpu.models import resnet as jax_resnet
from scenedepthestimation_tpu.ops import augment as jax_aug
from scenedepthestimation_tpu.ops.disp_to_depth import (
    sigmoid_disp_from_depth as jax_sigmoid_disp_from_depth,
)
from scenedepthestimation_tpu.ops.pallas.conv_block import conv3x3_xla
from scenedepthestimation_tpu.utils import torch_import
from scenedepthestimation_tpu_torch import configs, losses, train
from scenedepthestimation_tpu_torch.models import monodepth, resnet
from scenedepthestimation_tpu_torch.models.unet_decoder import DepthDecoder
from scenedepthestimation_tpu_torch.ops import augment, fused_tail
from scenedepthestimation_tpu_torch.ops.cuda import _build
from scenedepthestimation_tpu_torch.ops.cuda import conv_block
from scenedepthestimation_tpu_torch.ops.disp_to_depth import sigmoid_disp_from_depth
from scenedepthestimation_tpu_torch.utils import weights


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# conv3x3's backward
# ---------------------------------------------------------------------------


def _jax_conv(x, k, b, act, border):
    """The JAX reference: conv3x3_xla itself for reflect (the decoder's), the
    same conv on an edge or zero pad otherwise; the sigmoid head is
    conv3x3_xla's pre-activation through nn.sigmoid, as DispHead does."""
    if border == "reflect":
        y = conv3x3_xla(x, k, b, "elu" if act == "elu" else "none")
    else:
        mode = "edge" if border == "edge" else "constant"
        xp = jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)), mode=mode)
        y = jax.lax.conv_general_dilated(xp, k, (1, 1), "VALID",
                                         dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
        if act == "elu":
            y = jax.nn.elu(y)
    return jax.nn.sigmoid(y) if act == "sigmoid" else y


# (B, H, W, Cin, Cout, activation, border): Cin / Cout off 4, 8 and 16, the
# heads' Cout = 1, 1- and 2-pixel axes under every border.
BWD_CASES = [
    (2, 6, 10, 5, 7, "elu", "reflect"),
    (1, 5, 9, 12, 3, "elu", "edge"),
    (2, 4, 7, 6, 10, "elu", "zero"),
    (2, 6, 12, 16, 1, "sigmoid", "reflect"),
    (1, 1, 6, 4, 5, "elu", "reflect"),
    (1, 2, 5, 3, 4, "elu", "reflect"),
    (1, 5, 1, 4, 2, "elu", "edge"),
    (2, 2, 2, 3, 1, "sigmoid", "zero"),
    (1, 1, 1, 3, 3, "elu", "reflect"),
    (1, 3, 2, 9, 6, "none", "edge"),
]


@pytest.mark.parametrize("shape", BWD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_conv3x3_backward_matches_jax_vjp(shape):
    """conv3x3_backward_plain (what the CPU path's op backward runs) against
    jax.vjp of the JAX conv: dx, dweight and dbias each atol 1e-5 x max|g|
    of the tensor; the backward takes the forward's output, not its
    pre-activation. The same gradients come out of autograd through the
    wrapper (the op's registered backward)."""
    b, h, w, cin, cout, act, border = shape
    rng = np.random.default_rng(BWD_CASES.index(shape))
    x = _normal(rng, (b, h, w, cin))
    wt = _normal(rng, (cout, cin, 3, 3), 1.0 / np.sqrt(9 * cin))
    bias = _normal(rng, (cout,), 0.1)
    k = wt.transpose(2, 3, 1, 0)
    out, vjp = jax.vjp(lambda a, kk, bb: _jax_conv(a, kk, bb, act, border),
                       jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias))
    g = _normal(rng, out.shape)
    want_x, want_k, want_b = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    want = (want_x, want_k.transpose(3, 2, 0, 1), want_b)
    tx, tw, tb = (torch.from_numpy(a.copy()).requires_grad_() for a in (x, wt, bias))
    y = conv_block.conv3x3(tx, tw, tb, act, border)
    np.testing.assert_allclose(_np(y), np.asarray(out), rtol=1e-5, atol=1e-6)
    plain = conv_block.conv3x3_backward_plain(torch.from_numpy(g), y.detach(), tx.detach(),
                                              tw.detach(), act, border)
    autograd = torch.autograd.grad(y, (tx, tw, tb), torch.from_numpy(g))
    for name, got, via, ref in zip(("dx", "dw", "db"), plain, autograd, want):
        scale = max(float(np.abs(ref).max()), 1e-30)
        np.testing.assert_allclose(_np(got), ref, rtol=0, atol=1e-5 * scale, err_msg=name)
        assert torch.equal(got, via), name


def test_conv3x3_op_sends_the_weight_its_gradient_and_the_slab_none():
    """A recorded call goes through the registered op; the weight and bias
    get their gradients, the detached slab none."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_normal(rng, (1, 4, 5, 8))).requires_grad_()
    w = torch.from_numpy(_normal(rng, (4, 8, 3, 3))).requires_grad_()
    b = torch.zeros(4, requires_grad=True)
    slab = conv_block.arrange_slab(w.detach())
    y = conv_block.conv3x3(x, w, b, slab=slab)
    assert "sde_conv3x3" in y.grad_fn.name()
    y.sum().backward()
    assert w.grad is not None and b.grad is not None and x.grad is not None
    assert slab.grad is None and not slab.requires_grad
    with torch.no_grad():
        assert conv_block.conv3x3(x, w, b).grad_fn is None


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it takes a wrapper past its
    CPU branch to the card's route."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("trainable", ["x", "w", "b"])
def test_conv3x3_trains_through_its_op_on_the_card(monkeypatch, trainable):
    """conv3x3 with any argument that needs a gradient goes through the op
    on the card, and no longer refuses: it reaches the kernel launch (which
    fails here for want of the card and its compiler, not with the old
    NotImplementedError); the backward wrapper takes float32 only."""
    seen = []
    monkeypatch.setattr(conv_block, "conv3x3_op", lambda *a: seen.append(a) or a[0])
    shapes = {"x": (1, 4, 4, 4), "w": (4, 4, 3, 3), "b": (4,)}
    args = {k: torch.ones(s).as_subclass(_OnCard) for k, s in shapes.items()}
    args[trainable].requires_grad_()
    conv_block.conv3x3(args["x"], args["w"], args["b"])
    assert len(seen) == 1
    monkeypatch.undo()
    with pytest.raises(Exception) as launched:
        conv_block._conv3x3(args["x"], args["w"], args["b"])
    assert not isinstance(launched.value, NotImplementedError)
    g = torch.ones(1, 4, 4, 4, dtype=torch.bfloat16).as_subclass(_OnCard)
    with pytest.raises(TypeError, match="float32"):
        conv_block.conv3x3_backward(g, g, g, g)


# ---------------------------------------------------------------------------
# conv3x3's backward kernels: the dx decomposition and the dW strip schedule
# ---------------------------------------------------------------------------

DX_HW = [(1, 1), (1, 5), (2, 3), (3, 2), (5, 7)]


def _bwd_inputs(rng, b, h, w, cin, cout, act, border, dtype=np.float32):
    x = rng.normal(size=(b, h, w, cin)).astype(dtype)
    wt = (rng.normal(size=(cout, cin, 3, 3)) / np.sqrt(9 * cin)).astype(dtype)
    bias = (0.1 * rng.normal(size=(cout,))).astype(dtype)
    tx, tw = torch.from_numpy(x), torch.from_numpy(wt)
    out = conv_block.conv3x3_plain(tx, tw, torch.from_numpy(bias), act, border)
    g = torch.from_numpy(rng.normal(size=out.shape).astype(dtype))
    return g, out, tx, tw


@pytest.mark.parametrize("hw", DX_HW, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("act", ["elu", "sigmoid", "none"])
@pytest.mark.parametrize("border", ["reflect", "edge", "zero"])
def test_conv3x3_dx_decomposition_matches_the_plain_backward(border, act, hw):
    """The input's gradient as the kernels compute it, the zero-bordered conv
    of dpre with the flipped, transposed weight plus the fold of the border
    rows, columns and corners (conv3x3_dx_plain), equals autograd's through
    the bordered conv (conv3x3_backward_plain): atol 1e-6 x max|ref| in
    fp32, 1e-12 x in float64."""
    h, w = hw
    for dtype, tol in ((np.float32, 1e-6), (np.float64, 1e-12)):
        rng = np.random.default_rng(DX_HW.index(hw))
        g, out, x, wt = _bwd_inputs(rng, 2, h, w, 3, 4, act, border, dtype)
        ref = conv_block.conv3x3_backward_plain(g, out, x, wt, act, border)[0]
        dpre = conv_block.conv3x3_dpre_plain(g, out, act)
        got = conv_block.conv3x3_dx_plain(dpre, wt, border)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        scale = float(ref.abs().max())
        np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=tol * scale)


@pytest.mark.parametrize("cin,cout", [(3, 4), (16, 1), (1, 5), (9, 12)])
def test_dx_slab_read_back_per_tap_gives_the_flipped_weight(cin, cout):
    """The slab the dx interior runs on, read back per tap (ky, kx) over
    (co, ci), is w'[ci, co, ky, kx] = w[co, ci, 2 - ky, 2 - kx] transposed,
    and zero past Cout (to a multiple of 8) and Cin (to a multiple of 4)."""
    wt = torch.from_numpy(_normal(np.random.default_rng(cin * 31 + cout), (cout, cin, 3, 3)))
    slab = conv_block.arrange_dx_slab(wt)
    kp, np_ = -(-cout // 8) * 8, -(-cin // 4) * 4
    assert tuple(slab.shape) == (9, kp, np_)
    wp = conv_block.flip_weight(wt)
    for t in range(9):
        assert torch.equal(slab[t, :cout, :cin], wp[:, :, t // 3, t % 3].T)
    assert not slab[:, cout:].any() and not slab[:, :, cin:].any()


def _src_index(p, n, border):
    """csrc/conv3x3_bwd.cu's src_index."""
    if p < 0 or p >= n:
        if border == "zero":
            return -1
        if border == "reflect":
            p = -p if p < 0 else 2 * n - 2 - p
        else:
            p = 0 if p < 0 else n - 1
    return min(max(p, 0), n - 1)


def _fold_emulation(dpre, slab, cin, border, tile=32, kstep=32):
    """conv3x3_dx_fold_kernel's schedule in numpy: the destinations in
    segments that each start a tile (each row the border lands on without
    the columns, each such column without the rows, each corner; across the
    batch), tiles of 32 with the union of their pixels' taps, A the extra
    dpre terms a tap carries to a pixel (in row then column order), B the
    slab row of tap 8 - t, 32 output channels a step."""
    b, h, w, cout = dpre.shape
    slab = slab[:, :cout, :cin]
    top, bot = _src_index(-1, h, border), _src_index(h, h, border)
    left, right = _src_index(-1, w, border), _src_index(w, w, border)
    rows, cols = sorted({top, bot}), sorted({left, right})
    segments = ([[(bb, y, x) for bb in range(b) for x in range(w) if x not in cols]
                 for y in rows]
                + [[(bb, y, x) for bb in range(b) for y in range(h) if y not in rows]
                   for x in cols]
                + [[(bb, y, x) for bb in range(b)] for y in rows for x in cols])

    def lines(y, k, n, lo, hi):
        r = [y + 1 - k] if 0 <= y + 1 - k < n else []
        ident = bool(r)
        r += [0] if k == 0 and y == lo else []
        r += [n - 1] if k == 2 and y == hi else []
        return r, ident

    def terms(y, x, t):
        rs, idr = lines(y, t // 3, h, top, bot)
        cs, idc = lines(x, t % 3, w, left, right)
        return [(r, c) for i, r in enumerate(rs) for j, c in enumerate(cs)
                if not (i == 0 and j == 0 and idr and idc)]

    fold = np.zeros((b, h, w, cin), np.float32)
    for dests in segments:
        for t0 in range(0, len(dests), tile):
            px = dests[t0:t0 + tile]
            mask = [t for t in range(9) if any(terms(y, x, t) for _, y, x in px)]
            acc = np.zeros((len(px), cin), np.float32)
            for t in mask:
                a = np.stack([sum((dpre[bb, r, c] for r, c in terms(y, x, t)),
                                  np.zeros(cout, np.float32)) for bb, y, x in px])
                for k0 in range(0, cout, kstep):
                    acc += a[:, k0:k0 + kstep] @ slab[8 - t, k0:k0 + kstep]
            for (bb, y, x), v in zip(px, acc):
                fold[bb, y, x] += v
    return fold


@pytest.mark.parametrize("hw", DX_HW + [(6, 20), (12, 9)], ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("border", ["reflect", "edge"])
def test_fold_kernel_schedule_matches_the_plain_fold(border, hw):
    """The fold kernel's schedule, emulated in numpy on the slab of w', adds
    what conv3x3_dx_fold_plain says the border adds (atol 1e-6 x max|ref|):
    every destination once, every extra term once, no interior term."""
    h, w = hw
    rng = np.random.default_rng(h * 100 + w)
    dpre = _normal(rng, (3, h, w, 20))
    wt = torch.from_numpy(_normal(rng, (20, 6, 3, 3), 0.2))
    ref = _np(conv_block.conv3x3_dx_fold_plain(torch.from_numpy(dpre), wt, border))
    got = _fold_emulation(dpre, _np(conv_block.arrange_dx_slab_plain(wt)), 6, border)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def _dw_cfg(cin, cout):
    """csrc/conv3x3_bwd.cu's with_dw_cfg: (BM, BN, PW, strip rows)."""
    bn = 16 if cin <= 16 else (32 if cin <= 32 or (cin % 64 and cin % 32 == 0) else 64)
    if cout == 1:
        return 1, max(bn, 32), 16, 16
    bm = 16 if cout <= 16 else 32
    pw = 256 // ((bm // 2) * (bn // 4))
    return bm, bn, pw, max(4, pw)


def _dw_emulation(dpre, x, border, slices, tw=20):
    """conv3x3_dw_kernel's schedule in numpy float32: strips of TH x 20
    output pixels in slices; per strip the dpre tile and the input's
    (TH + 2) x 22 halo with the border taken from indices (zero outside
    under the zero border); the nine taps read as shifted windows of that
    one halo; each lane of a block walks its rows pixel by pixel; lanes
    added in lane order, slices in slice order."""
    b, h, w, cout = dpre.shape
    cin = x.shape[-1]
    _, _, pw, th = _dw_cfg(cin, cout)
    sh, sw = -(-h // th), -(-w // tw)
    strips = b * sh * sw
    per = -(-strips // slices)
    parts = []
    for sp in range(0, strips, per):
        lanes = [(np.zeros((9, cout, cin), np.float32), np.zeros(cout, np.float32))
                 for _ in range(pw)]
        for s in range(sp, min(strips, sp + per)):
            bb, rest = divmod(s, sh * sw)
            oy0, ox0 = (rest // sw) * th, (rest % sw) * tw
            halo = np.zeros((th + 2, tw + 2, cin), np.float32)
            for r in range(th + 2):
                for c in range(tw + 2):
                    hs = _src_index(oy0 - 1 + r, h, border)
                    ws = _src_index(ox0 - 1 + c, w, border)
                    if hs >= 0 and ws >= 0:
                        halo[r, c] = x[bb, hs, ws]
            for rr in range(th):
                acc, dacc = lanes[rr % pw]
                for c in range(tw):
                    if oy0 + rr >= h or ox0 + c >= w:
                        continue
                    d = dpre[bb, oy0 + rr, ox0 + c]
                    dacc += d
                    for t in range(9):
                        acc[t] += np.outer(d, halo[rr + t // 3, c + t % 3])
        acc = sum((a for a, _ in lanes[1:]), lanes[0][0].copy())
        dacc = sum((d for _, d in lanes[1:]), lanes[0][1].copy())
        parts.append((acc, dacc))
    dw = sum((a for a, _ in parts[1:]), parts[0][0].copy())
    db = sum((d for _, d in parts[1:]), parts[0][1].copy())
    return dw.transpose(1, 2, 0).reshape(cout, cin, 3, 3), db


@pytest.mark.parametrize("case", [
    (2, 5, 7, 6, 5, "reflect", 2), (1, 9, 23, 20, 33, "edge", 3),
    (2, 6, 20, 8, 1, "reflect", 4), (1, 3, 2, 40, 12, "zero", 1),
    (3, 1, 1, 4, 3, "reflect", 2)], ids=lambda c: "-".join(map(str, c)))
def test_dw_strip_schedule_matches_the_plain_dw(case):
    """The dW kernel's strip schedule (halo strips, nine taps from one staged
    tile, lanes and slices added in order), emulated in numpy, equals the
    plain dW and db (conv3x3_dw_plain) within 1e-5 x max|ref| of each, and
    gives the same bits twice."""
    b, h, w, cin, cout, border, slices = case
    rng = np.random.default_rng(h * w + cin)
    dpre, x = _normal(rng, (b, h, w, cout)), _normal(rng, (b, h, w, cin))
    ref_w, ref_b = (_np(t) for t in conv_block.conv3x3_dw_plain(
        torch.from_numpy(dpre), torch.from_numpy(x), border))
    got_w, got_b = _dw_emulation(dpre, x, border, slices)
    again_w, again_b = _dw_emulation(dpre, x, border, slices)
    for got, ref in ((got_w, ref_w), (got_b, ref_b)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    assert np.array_equal(got_w, again_w) and np.array_equal(got_b, again_b)


@pytest.mark.parametrize("border", ["reflect", "zero"])
def test_conv3x3_backward_parts_compose_to_the_plain_backward(border):
    """The wrappers of the backward's parts (dpre, dx, dW) on the CPU take
    their plain versions, and together give conv3x3_backward_plain's
    gradients: dx within 1e-6 x max|ref|, dW and db within 1e-5 x."""
    g, out, x, wt = _bwd_inputs(np.random.default_rng(7), 2, 6, 9, 5, 7, "elu", border)
    ref = conv_block.conv3x3_backward_plain(g, out, x, wt, "elu", border)
    dpre = conv_block.conv3x3_dpre(g, out, "elu")
    got = (conv_block.conv3x3_dx(dpre, wt, border),) + conv_block.conv3x3_dw(dpre, x, border)
    for name, a, r, tol in zip(("dx", "dw", "db"), got, ref, (1e-6, 1e-5, 1e-5)):
        np.testing.assert_allclose(_np(a), _np(r), rtol=0, atol=tol * float(r.abs().max()),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# BatchNorm in train mode: Flax's rule
# ---------------------------------------------------------------------------


def test_batchnorm_train_mode_matches_flax_over_three_updates():
    """One BatchNorm2d against Flax's nn.BatchNorm(use_running_average=False)
    over three batches from random running statistics: the output and the
    gradients of input, scale and bias at each step rtol 1e-5 (+ atol 1e-6
    x max), the running mean and variance after each rtol 1e-5. PyTorch's
    own rule (momentum 0.1, unbiased variance) differs at the first update."""
    rng = np.random.default_rng(0)
    c = 6
    bn = resnet.BatchNorm2d(c, eps=resnet.BN_EPS).train()
    scale, shift = _normal(rng, (c,)) + 1.0, _normal(rng, (c,), 0.1)
    mean0, var0 = _normal(rng, (c,), 0.2), rng.uniform(0.5, 1.5, c).astype(np.float32)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(shift))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    ref = torch.nn.BatchNorm2d(c, eps=resnet.BN_EPS).train()
    ref.load_state_dict(bn.state_dict())
    fbn = nn.BatchNorm(use_running_average=False, epsilon=resnet.BN_EPS)
    stats = {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(shift)}
    for step in range(3):
        x = _normal(rng, (4, 5, 7, c), 2.0) + 0.5  # NHWC
        g = _normal(rng, x.shape)

        def f(p, xx):
            y, mut = fbn.apply({"params": p, "batch_stats": stats}, xx, mutable=["batch_stats"])
            return jnp.sum(y * g), (y, mut)

        (_, (y, mut)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            params, jnp.asarray(x))
        stats = mut["batch_stats"]
        tx = torch.from_numpy(x.copy()).permute(0, 3, 1, 2).requires_grad_()
        out = bn(tx)
        out.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
        np.testing.assert_allclose(_np(out.permute(0, 2, 3, 1)), np.asarray(y), rtol=1e-5,
                                   atol=1e-6 * float(np.abs(y).max()))
        for got, want in ((tx.grad.permute(0, 2, 3, 1), gx), (bn.weight.grad, gp["scale"]),
                          (bn.bias.grad, gp["bias"])):
            want = np.asarray(want)
            np.testing.assert_allclose(_np(got), want, rtol=1e-5,
                                       atol=1e-6 * float(np.abs(want).max()))
        bn.zero_grad()
        np.testing.assert_allclose(_np(bn.running_mean), np.asarray(stats["mean"]), rtol=1e-5)
        np.testing.assert_allclose(_np(bn.running_var), np.asarray(stats["var"]), rtol=1e-5)
        ref(torch.from_numpy(x.copy()).permute(0, 3, 1, 2))
        if step == 0:
            assert not np.allclose(_np(ref.running_var), np.asarray(stats["var"]), rtol=1e-3)


def _seeded(model, seed):
    monodepth.init_parameters(model, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=gen))
                m.running_var.copy_(0.8 + 0.4 * torch.rand(m.running_var.shape, generator=gen))
    return model.train()


@pytest.mark.parametrize("which", ["resnet18", "bottleneck"])
def test_encoder_batchnorms_train_like_flax(which):
    """The ResNet-18 encoder and one Bottleneck (ResNet-50's block, stride 2
    with its downsample) in train mode against the JAX modules (train=True,
    batch_stats mutable) over three batches: the outputs rtol 1e-5 + atol
    5e-5 x max (float32 reassociation through up to 20 conv and BatchNorm
    layers, the last normalising 12 values a channel: measured 1.4e-5 x),
    every running mean and variance after each batch rtol 1e-5 (+ atol 1e-6
    x max); every BatchNorm of the port is Flax-rule."""
    rng = np.random.default_rng(1)
    if which == "resnet18":
        port = _seeded(resnet.ResNetEncoder(18), 0)
        jmod, shape = jax_resnet.ResNetEncoder(num_layers=18), (2, 64, 96, 3)
    else:
        port = _seeded(resnet.Bottleneck(32, 16, stride=2), 0)
        jmod, shape = jax_resnet.Bottleneck(channels=16, stride=2), (2, 12, 14, 32)
    assert all(type(m) is resnet.BatchNorm2d for m in port.modules()
               if isinstance(m, torch.nn.BatchNorm2d))
    variables = torch_import.convert_state_dict({k: v.numpy() for k, v in port.state_dict().items()})
    params, stats = variables["params"], variables["batch_stats"]
    apply = jax.jit(lambda p, s, x: jmod.apply({"params": p, "batch_stats": s}, x, train=True,
                                               mutable=["batch_stats"]))
    for _ in range(3):
        x = _normal(rng, shape)
        want, mut = apply(params, stats, jnp.asarray(x))
        stats = mut["batch_stats"]
        if which == "resnet18":
            got = port(torch.from_numpy(x))
        else:
            got = [port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)]
            want = [want]
        for a, b in zip(got, want):
            b = np.asarray(b)
            np.testing.assert_allclose(_np(a), b, rtol=1e-5, atol=5e-5 * float(np.abs(b).max()))
        ref = weights.from_jax_variables({"batch_stats": jax.tree_util.tree_map(np.asarray, stats)})
        sd = port.state_dict()
        assert ref
        for k, v in ref.items():
            np.testing.assert_allclose(_np(sd[k]), v.numpy(), rtol=1e-5,
                                       atol=1e-6 * float(v.abs().max()), err_msg=k)


# ---------------------------------------------------------------------------
# The mono supervised loss, the GT encoding, the augmentation
# ---------------------------------------------------------------------------


def test_sigmoid_disp_from_depth_matches_jax():
    """numpy and torch forms against the JAX function (numpy in, as the
    batchers call it): depth <= 0 maps to exactly 0, below min and above max
    clamp, max depth floors at eps; equal bit for bit."""
    rng = np.random.default_rng(2)
    d = rng.uniform(-5, 150, (40, 50)).astype(np.float32)
    d[:3] = 0.0
    d[3, :5] = [0.05, 0.1, 100.0, 1e6, -0.0]
    want = jax_sigmoid_disp_from_depth(d)
    got = sigmoid_disp_from_depth(d)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sigmoid_disp_from_depth(torch.from_numpy(d)).numpy(), want)
    assert (got[d <= 0] == 0).all() and (got[d > 0] > 0).all()


@pytest.mark.parametrize("scale", [0, 1, 2, 3])
def test_downsample_image_matches_jax(scale):
    """_downsample_image at each scale on odd sizes (the VALID trim): equal
    to JAX's bit for bit."""
    x = _normal(np.random.default_rng(scale), (2, 27, 43, 3))
    want = np.asarray(jax_losses._downsample_image(jnp.asarray(x), scale))
    np.testing.assert_array_equal(_np(losses._downsample_image(torch.from_numpy(x), scale)), want)


@pytest.mark.parametrize("scales", [(0, 1, 2, 3), (0, 1)])
def test_mono_supervised_loss_matches_jax(scales):
    """mono_supervised_loss on sigmoid disparities at each scale, GT with a
    third invalid and exact ties (disparity equal to its GT, where JAX's
    |x| has slope +1): value rtol 1e-5, the gradient of every scale's
    disparity and of the image rtol 1e-5 + atol 1e-6 x max."""
    rng = np.random.default_rng(4)
    b, h, w = 2, 32, 48
    disps = {s: rng.uniform(0.05, 0.95, (b, h >> s, w >> s, 1)).astype(np.float32)
             for s in scales}
    gt = rng.uniform(0.02, 0.9, (b, h, w, 1)).astype(np.float32)
    gt[rng.uniform(size=gt.shape) < 0.33] = 0.0
    gt[0, 0, :6, 0] = disps[0][0, 0, :6, 0]  # ties at scale 0
    img = rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    img[:, :4, :8] = 0.5  # flat patches: image-gradient ties
    want, (want_d, want_i) = jax.jit(jax.value_and_grad(
        lambda d, im: jax_losses.mono_supervised_loss(d, jnp.asarray(gt), im), argnums=(0, 1)))(
        {s: jnp.asarray(v) for s, v in disps.items()}, jnp.asarray(img))
    td = {s: torch.from_numpy(v.copy()).requires_grad_() for s, v in disps.items()}
    ti = torch.from_numpy(img.copy()).requires_grad_()
    got = losses.mono_supervised_loss(td, torch.from_numpy(gt), ti)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    got.backward()
    for s in scales:
        ref = np.asarray(want_d[s])
        np.testing.assert_allclose(_np(td[s].grad), ref, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(ref).max()), err_msg=f"scale {s}")
    ref = np.asarray(want_i)
    np.testing.assert_allclose(_np(ti.grad), ref, rtol=1e-5, atol=1e-6 * float(np.abs(ref).max()))


def _jax_mono_draws(key, b):
    """The draws JAX's augment_mono makes from ``key``, in its split order."""
    kf, kj, kp = jax.random.split(key, 3)
    draws = {"flip": jax.random.bernoulli(kf, 0.5, (b,))}
    draws.update(jax_aug._jitter_factors(kj, b, jnp.float32, 0.2, 0.2, 0.2, 0.05))
    draws["jitter"] = jax.random.bernoulli(kp, 1.0, (b,))
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


@pytest.mark.parametrize("gt", [True, False], ids=["gt", "image_only"])
def test_augment_mono_transform_matches_jax_given_its_draws(gt):
    """augment_mono with JAX's own draws (its key split replayed) against
    JAX's augment_mono: the image rtol 1e-5 + atol 1e-6, the GT flipped
    with it exactly; both flip states occur in the batch."""
    rng = np.random.default_rng(5)
    b = 6
    batch = {"image": rng.uniform(0, 1, (b, 12, 20, 3)).astype(np.float32)}
    if gt:
        batch["gt_disp"] = rng.uniform(0, 1, (b, 12, 20, 1)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = jax_aug.augment_mono(key, {k: jnp.asarray(v) for k, v in batch.items()})
    draws = _jax_mono_draws(key, b)
    assert 0 < int(draws["flip"].sum()) < b
    got = augment.augment_mono({k: torch.from_numpy(v) for k, v in batch.items()}, draws)
    np.testing.assert_allclose(_np(got["image"]), np.asarray(want["image"]), rtol=1e-5, atol=1e-6)
    if gt:
        np.testing.assert_array_equal(_np(got["gt_disp"]), np.asarray(want["gt_disp"]))


def test_port_mono_draws_hold_their_ranges():
    """draw_mono from a seeded CPU generator: flags bool (B,), factors in
    their ranges, the same draws for the same seed."""
    d = augment.draw_mono(torch.Generator().manual_seed(3), 64)
    assert d["flip"].dtype == torch.bool and d["flip"].shape == (64,)
    assert 0 < int(d["flip"].sum()) < 64 and bool(d["jitter"].all())
    for k in ("brightness", "contrast", "saturation"):
        assert d[k].shape == (64, 1, 1, 1) and bool(((d[k] >= 0.8) & (d[k] < 1.2)).all())
    assert bool((d["hue"].abs() <= 0.05).all())
    again = augment.draw_mono(torch.Generator().manual_seed(3), 64)
    assert all(torch.equal(d[k], again[k]) for k in d)


# ---------------------------------------------------------------------------
# The decoder's training route
# ---------------------------------------------------------------------------


def test_kept_slab_follows_the_optimizer_step(monkeypatch):
    """The decoder's kept weight slabs are keyed on each weight's version:
    after TrainState.apply_gradients (an in-place update under no_grad) the
    next forward hands every conv3x3 call the slab of the new weight, never
    the stale one. (The slab path is switched on here by pretending the
    tensors are on the card; the CPU conv reads the weight itself.)"""
    from scenedepthestimation_tpu_torch.models import unet_decoder

    calls = []
    real = conv_block.conv3x3

    def spy(x, weight, bias, activation="elu", border="reflect", out_dtype=None, slab=None):
        if weight.shape[0] > 1:
            calls.append((weight.detach().clone(), slab))
        return real(x, weight, bias, activation, border, out_dtype)

    monkeypatch.setattr(conv_block, "uses_slab", lambda x, cout: cout > 1)
    monkeypatch.setattr(unet_decoder.conv_block, "conv3x3", spy)
    cfg = configs.get("mono_kitti_192x640_fp32")
    small = cfg.__class__(**{**cfg.__dict__, "batch_size": 1,
                             "mono": cfg.mono.__class__(**{**cfg.mono.__dict__, "height": 32,
                                                           "width": 64})})
    st = train.make_train_state(small, device="cpu", learning_rate=1e-2)
    step = train.make_mono_train_step(small)
    rng = np.random.default_rng(6)
    batch = {"image": torch.from_numpy(rng.integers(0, 256, (1, 32, 64, 3), dtype=np.uint8)),
             "gt_disp": torch.from_numpy(rng.uniform(0.1, 0.9, (1, 32, 64, 1)).astype(np.float32))}
    for _ in range(2):
        calls.clear()
        st, _ = step(st, batch)
        assert len(calls) == 10
        for w, slab in calls:
            assert torch.equal(slab, conv_block.arrange_slab_plain(w))
    first_w, _ = calls[0]
    assert not torch.equal(first_w, st.model.decoder.upconv_4_0.conv.weight.detach())


def test_fused_tail_stays_off_a_recorded_forward(monkeypatch):
    """With the fused tail switched on, a forward that autograd records runs
    level 0 as two ConvBlocks (the fused kernel has no backward; JAX trains
    the standard decoder); an inference forward takes the fused tail."""
    taken = []
    real = fused_tail.fused_tail
    monkeypatch.setattr(fused_tail, "fused_tail", lambda *a, **k: taken.append(1) or real(*a, **k))
    dec = DepthDecoder()
    gen = torch.Generator().manual_seed(0)
    feats = [torch.randn((1, 32 >> i, 64 >> i, c), generator=gen)
             for i, c in enumerate((64, 64, 128, 256, 512))]
    prev = fused_tail._USE_FUSED_TAIL
    fused_tail.set_use_fused_tail(True)
    try:
        out = dec(feats)
        assert not taken and out[0].requires_grad
        with torch.no_grad():
            ref = dec(feats)
        assert len(taken) == 1
        np.testing.assert_allclose(_np(out[0]), _np(ref[0]), rtol=1e-5, atol=1e-6)
    finally:
        fused_tail.set_use_fused_tail(prev)
    assert _build.needs_grad(out[0])


def test_mono_train_state_keeps_the_decoder_weights_contiguous():
    """The conv3x3 kernels read contiguous (Cout, Cin, 3, 3) weights: a mono
    train state puts only the encoder's cuDNN convs in channels-last
    memory, and the decoder's weights (and Adam's moments of them) stay
    contiguous."""
    from scenedepthestimation_tpu_torch.models.unet_decoder import Conv3x3

    st = train.make_train_state(configs.get("mono_kitti_192x640_fp32"), device="cpu")
    convs = [m for m in st.model.modules() if isinstance(m, Conv3x3)]
    assert len(convs) == 14 and all(m.weight.is_contiguous() for m in convs)
    enc = [m.weight for m in st.model.encoder.modules() if isinstance(m, torch.nn.Conv2d)]
    assert all(w.is_contiguous(memory_format=torch.channels_last) for w in enc)
    names = [n for n, _ in st.model.named_parameters()]
    for n, mu in zip(names, st.tx.mu):
        if n.startswith("decoder.") and mu.dim() == 4:
            assert mu.is_contiguous(), n
