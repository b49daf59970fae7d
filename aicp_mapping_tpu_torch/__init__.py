"""aicp_mapping_tpu_torch — the AICP LiDAR SLAM engine in PyTorch and CUDA.

A port of `aicp_mapping_tpu` (JAX on a TPU) to PyTorch on an NVIDIA H100.
It mirrors the JAX package's module paths and public names; the JAX package
is the reference every ported function is tested against. The per-frame
AICP path (voxel downsample -> hough prefilter -> voxel-set overlap ->
auto-tuned trimmed ICP -> gates), with failure prediction (FOV overlap,
alignability, the risk classifier and its gate) when asked, runs end to end
through `App(config).process_cloud(...)`, or pipelined through
`App.submit_cloud` / `flush` and `pipeline.SequenceRunner(pipelined=True)`
with async finalize and the int16 wire format, or online through
`pipeline.stream.StreamingDriver`; map-scale localization against a
prior map through the App's map modes and `parallel.ShardedMapLocalizer`;
one scan pair through `python -m aicp_mapping_tpu_torch register`; the SLAM
back-end (loop closures, pose-graph optimization, plane BA) through
`pipeline.mapper.PoseGraphMapper`, `python -m aicp_mapping_tpu_torch slam`
and `eval.slam_accuracy`; recorded sequences through the `replay`,
`accumulate` and `localize` commands; what the App publishes through the
visualizer sinks of `utils` (the live TCP viewer among them). It answers
to the JAX package's public names (the few renamed or left out stand in
tests/test_torch_surface.py). The entry points run on the card unless
given `device="cpu"`. The TPU kernels on those paths are hand-written
CUDA C++ for sm_90a (see `_kernels`).

This package imports torch and numpy only (matplotlib inside
`eval.plots`' functions), never jax or the JAX package: the machines that
run it have no JAX.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry correctness: TF32 keeps ~10 mantissa bits, which at 60 m lidar
# coordinates is tens of centimetres in a transformed point and several
# square metres in an expanded squared distance — the same hazard the JAX
# package pins away for the TPU's bf16 matmuls. Full FP32 everywhere.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from .cloud import (  # noqa: E402,F401
    AlignedCloud,
    AlignedCloudsGraph,
    Cloud,
    NormalCloud,
)
from .geometry import se3  # noqa: E402,F401
from .pipeline.app import App, FrameResult  # noqa: E402,F401
from .pipeline.config import (  # noqa: E402,F401
    PipelineConfig,
    load_yaml_config,
)
from .registration.icp import (  # noqa: E402,F401
    ICPConfig,
    ICPResult,
    clamp_trim_ratio,
    point_to_plane_icp,
)
