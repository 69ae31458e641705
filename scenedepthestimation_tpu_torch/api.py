"""Public inference API of the port: the counterpart of
``scenedepthestimation_tpu/api.py`` (``load_weights``, ``predict_mono``,
``predict_stereo``).

A :class:`Predictor` owns the config, the network on its device and the
end-to-end program of its pipeline:

* mono: uint8 frames -> preprocess -> encoder -> decoder -> scale-0
  sigmoid head -> (flip blend) -> resize to source size -> disp->depth;
* stereo: uint8 rectified pairs -> one preprocess over the interleaved
  pair -> feature tower -> correlation -> aggregation -> soft-argmin x
  feat_stride -> (refinement) -> x4 bilinear -> resize to source size
  with the disparity rescaled by the width ratio -> depth = f*B/disp.

The host only hands in decoded uint8 frames and takes depth maps out.
PyTorch runs eagerly, so there is no program cache to keep. bf16 stereo
presets run the network in bf16 with the banded-Gram correlation kernel
and read the soft-argmin out in fp32, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from scenedepthestimation_tpu_torch import configs
from scenedepthestimation_tpu_torch.configs import RunConfig
from scenedepthestimation_tpu_torch.models import folded, monodepth, stereo
from scenedepthestimation_tpu_torch.models.unet_decoder import Conv3x3
from scenedepthestimation_tpu_torch.ops.disp_to_depth import depth_from_disparity, disp_to_depth
from scenedepthestimation_tpu_torch.ops.preprocess import preprocess, resize_bilinear
from scenedepthestimation_tpu_torch.utils import weights as weights_io


def compute_dtype(cfg: RunConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _blend_flipped(disp: torch.Tensor, disp_flip: torch.Tensor) -> torch.Tensor:
    """monodepth flip-averaging: ramp in the un-mirrored map near the
    left edge, the mirrored map near the right, mean in between."""
    w = disp.shape[2]
    xs = torch.linspace(0.0, 1.0, w, dtype=disp.dtype, device=disp.device)
    xs = xs[None, None, :, None]
    # Family convention: full weight to the mirrored view inside the left
    # 5% border, ramp over the next 5%, symmetric on the right.
    l_mask = 1.0 - torch.clamp(20.0 * (xs - 0.05), 0.0, 1.0)
    r_mask = l_mask.flip(2)
    mean = 0.5 * (disp + disp_flip)
    return r_mask * disp + l_mask * disp_flip + (1.0 - l_mask - r_mask) * mean


def _takes_collapsed_decoder(mono: configs.MonoConfig) -> bool:
    """Where the JAX mono program runs its collapsed decoder (``use_packed``
    in ``scenedepthestimation_tpu/api.py``: the packed decoder, a nearest
    upsample, H and W divisible by 4, scale 0 among the scales), the only
    place its fast borders take effect."""
    return (
        mono.packed_decoder
        and mono.upsample_mode == "nearest"
        and mono.height % 4 == 0
        and mono.width % 4 == 0
        and 0 in mono.scales
    )


class Predictor:
    """The network of one pipeline on one device, and its end-to-end
    program (:meth:`mono_forward` or :meth:`stereo_forward`).

    A mono preset with ``fold_bn`` runs the BN-folded encoder
    (``models/folded.py``), folded here in fp32 from the model's weights.
    With ``fast_borders`` the decoder runs the JAX program's fast-border
    mode (zero-bordered convs, ``models/unet_decoder.py``) where the JAX
    program takes its collapsed decoder (``_takes_collapsed_decoder``),
    and the reflect decoder elsewhere, as the JAX program does. On CUDA the
    decoder's weight slabs for the conv3x3 kernel (Cout > 1, bf16 and
    fp32) are made here, once.

    On CUDA with a float32 preset it turns TF32 off for cuDNN convolutions
    and matmuls (``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32``, process-wide): otherwise the
    fp32 cuDNN convs run in TF32, which keeps about three decimal digits.
    """

    def __init__(self, cfg: RunConfig, model: torch.nn.Module, device: torch.device):
        if cfg.pipeline not in ("mono", "stereo"):
            raise ValueError(f"unknown pipeline {cfg.pipeline!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = compute_dtype(cfg)
        if self.device.type == "cuda" and self.dtype == torch.float32:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        if (
            cfg.pipeline == "mono"
            and cfg.mono.fold_bn
            and not isinstance(model.encoder, folded.FoldedEncoder)
        ):
            # Fold in fp32, before the cast to the compute dtype. The
            # space-to-depth stem (cfg.mono.s2d_stem) is an exact relayout
            # of the plain stem, which runs either way.
            model.encoder = folded.FoldedEncoder.from_encoder(model.encoder)
        model = model.to(device=self.device, dtype=self.dtype).eval()
        # Channels-last cuDNN convs: their NHWC inputs and outputs are then
        # NCHW views with no copies. The mono decoder keeps its (Cout, Cin,
        # 3, 3) weights contiguous, as the conv3x3 kernel reads them.
        if cfg.pipeline == "mono":
            model.encoder.to(memory_format=torch.channels_last)
            fast = cfg.mono.fast_borders and _takes_collapsed_decoder(cfg.mono)
            model.decoder.border_mode = "fast" if fast else "exact"
            if self.device.type == "cuda":
                for m in model.decoder.modules():
                    if isinstance(m, Conv3x3) and m.weight.shape[0] > 1:
                        m.slab()
        else:
            model.to(memory_format=torch.channels_last)
        self.model = model

    @torch.inference_mode()
    def mono_forward(
        self, img: torch.Tensor, post_process: bool = False
    ) -> Dict[str, torch.Tensor]:
        """uint8 (B, H, W, 3) on the predictor's device -> {'disp',
        'depth'} (B, H, W) float32 at the source resolution.

        ``post_process`` runs the flip-averaging TTA: the batch is doubled
        with mirrored frames and the two disparities are blended.
        """
        cfg = self.cfg
        net_hw = (cfg.mono.height, cfg.mono.width)
        src_hw = tuple(img.shape[-3:-1])
        x = preprocess(img, net_hw, cfg.pre, compute_dtype=self.dtype)
        if post_process:
            x = torch.cat([x, x.flip(2)], dim=0)
        disp0 = self.model(x, scales=(0,))[0].float()  # (B', h, w, 1)
        if post_process:
            b = img.shape[0]
            disp0 = _blend_flipped(disp0[:b], disp0[b:].flip(2))
        if src_hw != net_hw:
            disp0 = resize_bilinear(disp0, src_hw, antialias=False)
        scaled_disp, depth = disp_to_depth(
            disp0[..., 0], cfg.mono.min_depth, cfg.mono.max_depth
        )
        return {"disp": scaled_disp, "depth": depth}

    @torch.inference_mode()
    def stereo_forward(
        self, left: torch.Tensor, right: torch.Tensor
    ) -> Dict[str, torch.Tensor]:
        """uint8 (B, H, W, 3) rectified pair on the predictor's device ->
        {'disp' (px), 'depth' (m)}, (B, H, W) float32 at the source
        resolution."""
        cfg = self.cfg
        net_hw = (cfg.stereo.height, cfg.stereo.width)
        src_hw = tuple(left.shape[-3:-1])
        # One preprocess over the (B, 2, ...) -> (2B, ...) interleaved pair,
        # which the tower takes as it is.
        pair = torch.stack([left, right], dim=1)
        pair = pair.reshape((2 * left.shape[0],) + tuple(pair.shape[2:]))
        xp = preprocess(pair, net_hw, cfg.pre, compute_dtype=self.dtype)
        disp = self.model.forward_pair(xp).float()  # (B, h, w) px at net res
        if src_hw != net_hw:
            # Disparities are horizontal offsets: rescale them by the width
            # ratio when resizing back to the source resolution.
            disp = resize_bilinear(disp[..., None], src_hw, antialias=False)[..., 0]
            disp = disp * (src_hw[1] / net_hw[1])
        depth = depth_from_disparity(disp, cfg.stereo.focal_px, cfg.stereo.baseline_m)
        return {"disp": disp, "depth": depth}


def load_weights(
    path: Optional[str],
    config: "str | RunConfig" = "mono_kitti_192x640_fp32",
    seed: int = 0,
    device: "str | torch.device" = "cuda",
) -> Predictor:
    """Weights -> a :class:`Predictor` on ``device``.

    ``path`` takes the JAX package's forms (``utils/weights.load_path``): a
    directory of ``.pth`` files in the family's layout (mono:
    ``encoder.pth`` + ``depth.pth``; stereo: every file merged), or one
    ``.pth`` / ``.pt`` state-dict file; an Orbax checkpoint directory
    raises with the conversion command. ``None`` makes seeded random
    weights (a ``torch.Generator`` on the CPU, so every device gets the
    same numbers). Stereo weights that hold a refinement
    stage switch ``refine`` on, as the JAX package does: served without
    it, the network would return the coarse readout. ``device="cuda"``
    raises when CUDA is not available: nothing falls back to the CPU.
    """
    cfg = configs.get(config)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    state = None if path is None else weights_io.load_path(path)
    if cfg.pipeline == "mono":
        model, init = monodepth.MonoDepthNet(cfg.mono), monodepth.init_parameters
    else:
        if (
            state is not None
            and not cfg.stereo.refine
            and any(k.startswith("refinement.") for k in state)
        ):
            cfg = dataclasses.replace(
                cfg, stereo=dataclasses.replace(cfg.stereo, refine=True)
            )
        model, init = stereo.StereoNet(cfg.stereo), stereo.init_parameters
    if state is None:
        init(model, torch.Generator().manual_seed(seed))
    else:
        weights_io.load_state(model, state)
    return Predictor(cfg, model, device)


def _ensure_batched(img, device: torch.device) -> Tuple[torch.Tensor, bool]:
    if not torch.is_tensor(img):
        img = torch.from_numpy(np.ascontiguousarray(img))
    arr = img.to(device)
    if arr.dim() == 3:
        return arr[None], True
    if arr.dim() == 4:
        return arr, False
    raise ValueError(f"expected (H,W,3) or (B,H,W,3), got {tuple(arr.shape)}")


def predict_mono(
    predictor: Predictor, image, post_process: bool = False
) -> Dict[str, np.ndarray]:
    """Depth map from a single RGB image (or batch). uint8 HWC in.

    Returns numpy {'depth': (.., H, W), 'disp': (.., H, W)} at the source
    resolution, squeezed if the input was unbatched. ``post_process``
    enables flip-averaging TTA (doubles compute).
    """
    img, squeeze = _ensure_batched(image, predictor.device)
    out = predictor.mono_forward(img, post_process=post_process)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    if squeeze:
        out = {k: v[0] for k, v in out.items()}
    return out


def predict_stereo(predictor: Predictor, left, right) -> Dict[str, np.ndarray]:
    """Disparity (px) and depth (m) from a rectified stereo pair (or batch
    of pairs), uint8 HWC in. Returns numpy {'depth', 'disp'} at the source
    resolution, squeezed if the input was unbatched."""
    l, squeeze = _ensure_batched(left, predictor.device)
    r, _ = _ensure_batched(right, predictor.device)
    if l.shape != r.shape:
        raise ValueError(
            f"left/right shapes must match: {tuple(l.shape)} vs {tuple(r.shape)} "
            "(rectified pairs share a resolution)"
        )
    out = predictor.stereo_forward(l, r)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    if squeeze:
        out = {k: v[0] for k, v in out.items()}
    return out


def predict_batch(predictor: Predictor, images: Iterable, mesh=None) -> List[Dict[str, np.ndarray]]:
    """Batched inference over an iterable of batches on the predictor's
    device: mono batches are uint8 (B, H, W, 3) arrays, stereo batches
    (left, right) pairs of them. Returns one numpy {'disp', 'depth'} dict
    per batch, in order.

    ``mesh`` is the JAX package's device mesh for sharding each batch over
    several chips; the port runs on one device until multi-GPU is ported,
    so any mesh other than None raises.
    """
    if mesh is not None:
        raise NotImplementedError("predict_batch over a device mesh (multi-GPU) is not ported")
    results = []
    for batch in images:
        if predictor.cfg.pipeline == "stereo":
            left, right = batch
            out = predictor.stereo_forward(
                _ensure_batched(left, predictor.device)[0],
                _ensure_batched(right, predictor.device)[0],
            )
        else:
            out = predictor.mono_forward(_ensure_batched(batch, predictor.device)[0])
        results.append({k: v.cpu().numpy() for k, v in out.items()})
    return results
