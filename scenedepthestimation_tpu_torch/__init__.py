"""PyTorch / CUDA port of ``scenedepthestimation_tpu`` for NVIDIA Hopper.

Ported: mono inference (preprocess -> ResNet encoder -> U-Net decoder ->
sigmoid disparity head -> disp->depth), with the decoder's convs and skip
joins in hand-written CUDA kernels, and fp32 and bf16 stereo inference
(feature tower -> correlation cost volume -> aggregation U-Net ->
soft-argmin -> refinement -> disparity and depth), with the correlation
(fp32; a tensor-core banded Gram for bf16), the soft-argmin and the
aggregation's skip joins in hand-written CUDA kernels; the judged mono
bench (``benchmark.run_bench``, ``benchmark.parity_abs_rel``) in bf16 at
b128, with the decoder's level-0 tail as one fused kernel when
``ops.fused_tail.set_use_fused_tail`` is on. The kernels
(``csrc/``) are built with ``nvcc`` at first use. The package imports
``torch`` and never ``jax``; the JAX package beside it is the reference
the port's tests hold it against.

    import scenedepthestimation_tpu_torch as sdt
    p = sdt.load_weights(None, "mono_kitti_192x640_fp32", seed=0, device="cuda")
    out = sdt.predict_mono(p, frame_uint8_hwc)   # {'depth', 'disp'} numpy
    s = sdt.load_weights(None, "stereo_256x512_b4", seed=0, device="cuda")
    out = sdt.predict_stereo(s, left_uint8_hwc, right_uint8_hwc)
    outs = sdt.predict_batch(p, [batch_uint8_bhwc, ...])  # one dict per batch
"""

from scenedepthestimation_tpu_torch import configs
from scenedepthestimation_tpu_torch.api import (
    Predictor,
    load_weights,
    predict_batch,
    predict_mono,
    predict_stereo,
)

__all__ = [
    "configs",
    "Predictor",
    "load_weights",
    "predict_batch",
    "predict_mono",
    "predict_stereo",
]
