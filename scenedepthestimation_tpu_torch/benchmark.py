"""Throughput benchmark and reference parity of the port, the counterpart of
``scenedepthestimation_tpu/benchmark.py`` (``reference_cpu_fps``,
``parity_abs_rel``, ``run_bench``).

``run_bench`` times the full device program (on-device preprocess, forward,
disp->depth) on uint8 frames already on the device, so the number is the
card's compute throughput; the host feed is not in it. ``parity_abs_rel``
is the judged accuracy figure: the abs-rel delta of the port's depth
against the torch re-derivation of the reference (``tools/torch_ref.py``)
on its seed-0 weights.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from scenedepthestimation_tpu_torch import configs
from scenedepthestimation_tpu_torch.api import Predictor, load_weights
from scenedepthestimation_tpu_torch.configs import RunConfig
from scenedepthestimation_tpu_torch.models.monodepth import MonoDepthNet
from scenedepthestimation_tpu_torch.utils import weights as weights_io

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# torch-CPU fp32 forward of the same architecture at the judged shape,
# written by tools/measure_torch_baseline.py.
_BASELINE_FILE = os.path.join(_REPO, "goldens", "torch_cpu_baseline.json")
_TORCH_REF = os.path.join(_REPO, "tools", "torch_ref.py")


def reference_cpu_fps() -> Optional[float]:
    try:
        with open(_BASELINE_FILE) as f:
            return float(json.load(f)["frames_per_sec"])
    except (OSError, KeyError, ValueError):
        return None


def _with_overrides(cfg: RunConfig, overrides: Optional[dict]) -> RunConfig:
    """``{"mono.fold_bn": True, "dtype": "float32", ...}``: replace
    fields of the config and of its nested sections."""
    for key, val in (overrides or {}).items():
        section, _, field = key.partition(".")
        if not field:
            cfg = dataclasses.replace(cfg, **{section: val})
        else:
            sub = dataclasses.replace(getattr(cfg, section), **{field: val})
            cfg = dataclasses.replace(cfg, **{section: sub})
    return cfg


def _torch_ref():
    """tools/torch_ref.py, loaded from its path (a sys.path entry would let
    tools/ shadow imports process-wide)."""
    spec = importlib.util.spec_from_file_location("torch_ref", _TORCH_REF)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def parity_abs_rel(
    dtype: str = "float32",
    overrides: Optional[dict] = None,
    device: "str | torch.device" = "cuda",
) -> float:
    """abs-rel delta of the port's depth against the reference output,
    ``mean(|d_port - d_ref| / d_ref)``.

    The reference is ``tools/torch_ref.MonoDepthNet`` with seed-0 weights,
    run in fp32 on the CPU; its ``state_dict`` loads into the port by name.
    One fixed 192x640 uint8 frame from ``numpy.random.default_rng(0)``
    goes through both; the port runs ``mono_kitti_192x640_fp32`` in
    ``dtype`` on ``device``.
    """
    torch_ref = _torch_ref()
    torch.manual_seed(0)
    tmodel = torch_ref.MonoDepthNet().eval()
    state = {k: v for k, v in tmodel.state_dict().items() if not k.endswith("num_batches_tracked")}

    img = np.random.default_rng(0).integers(0, 256, size=(1, 192, 640, 3), dtype=np.uint8)
    cfg = configs.get("mono_kitti_192x640_fp32")
    x = (img.astype(np.float32) / 255.0 - np.asarray(cfg.pre.mean)) / np.asarray(cfg.pre.std)
    with torch.no_grad():
        disp_t = tmodel(torch.from_numpy(x.astype(np.float32).transpose(0, 3, 1, 2)))[0].numpy()
    min_disp, max_disp = 1.0 / cfg.mono.max_depth, 1.0 / cfg.mono.min_depth
    depth_ref = 1.0 / (min_disp + (max_disp - min_disp) * disp_t[:, 0])

    run_cfg = _with_overrides(dataclasses.replace(cfg, dtype=dtype), overrides)
    model = MonoDepthNet(run_cfg.mono)
    weights_io.load_state(model, state)
    predictor = Predictor(run_cfg, model, device)
    img_t = torch.from_numpy(img).to(predictor.device)
    depth = predictor.mono_forward(img_t)["depth"].cpu().numpy()
    return float(np.mean(np.abs(depth - depth_ref) / depth_ref))


def run_bench(
    config: str = "mono_kitti_384x1152_bench",
    batch_size: Optional[int] = None,
    iters: int = 32,
    warmup: int = 2,
    overrides: Optional[dict] = None,
    device: "str | torch.device" = "cuda",
) -> dict:
    """Time ``iters`` end-to-end forwards of seeded weights, eager.

    Each forward takes the frames perturbed by its loop index (uint8
    wraparound), so no two forwards are the same work, and adds its depth
    mean to a sum on the device; the host syncs once, when it reads the
    sum at the end, and its clock around the loop gives frames/s.
    ``warmup`` forwards run first (cuDNN picks its algorithms there).
    Returns the JAX package's keys; ``device`` is the card's name.
    """
    cfg = configs.get(config)
    if batch_size is not None:
        cfg = dataclasses.replace(cfg, batch_size=batch_size)
    cfg = _with_overrides(cfg, overrides)
    b = cfg.batch_size
    predictor = load_weights(None, cfg, seed=0, device=device)
    dev = predictor.device

    rng = np.random.default_rng(0)
    shape = (b, cfg.height, cfg.width, 3)
    if cfg.pipeline == "mono":
        img = torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8)).to(dev)

        def forward(i: int) -> torch.Tensor:
            return predictor.mono_forward(img + (i % 256))["depth"].mean()

    else:
        left = torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8)).to(dev)
        right = torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8)).to(dev)

        def forward(i: int) -> torch.Tensor:
            return predictor.stereo_forward(left + (i % 256), right + (i % 256))["depth"].mean()

    for i in range(warmup):
        float(forward(i))
    acc = torch.zeros((), dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    for i in range(iters):
        acc += forward(i)
    checksum = float(acc)  # the one sync
    dt = time.perf_counter() - t0

    fps = b * iters / dt
    base = reference_cpu_fps()
    return {
        "metric": f"{cfg.pipeline}_frames_per_sec_per_chip_{cfg.height}x{cfg.width}",
        "value": round(fps, 2),
        "unit": "frames/sec/chip",
        "vs_baseline": round(fps / base, 2) if base else None,
        "batch_size": b,
        "dtype": cfg.dtype,
        "iters": iters,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        "reference_cpu_fps": base,
        "checksum": checksum,
    }
