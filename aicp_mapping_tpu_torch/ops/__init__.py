"""Point-cloud operators; the export list of `aicp_mapping_tpu.ops`.

`nn_argmin` is the exact 1-NN entry point, as in the JAX package: kernel
K1's index mode on a CUDA tensor, its plain version `ops.knn.nn_argmin` on
a CPU tensor (JAX: the Pallas kernel on a TPU, XLA elsewhere).
`nn_argmin_kernel` stands for JAX's `nn_argmin_pallas`; JAX's
`nn_argmin_xla` is the plain version, which `nn_argmin` runs off the card.
As in the JAX package, the function `knn` shadows the submodule of that
name: import the module as `aicp_mapping_tpu_torch.ops.knn` through
`importlib` or `from aicp_mapping_tpu_torch.ops.knn import ...`.
"""
from .knn import knn, nn_argmin_kernel  # noqa: F401
from .knn import nn_argmin_kernel as nn_argmin  # noqa: F401
from .normals import estimate_normals, normals_from_neighbors  # noqa: F401
from .quantile import masked_mean, masked_median, masked_quantile  # noqa: F401
from .voxel import (  # noqa: F401
    crop_box,
    unique_voxel_count,
    voxel_downsample,
    voxel_keys,
    voxel_set_overlap,
)
