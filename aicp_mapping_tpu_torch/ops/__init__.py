"""Point-cloud operators. `ops.nn_argmin` is the exact 1-NN entry point, as
in the JAX package: kernel K1's index mode on a CUDA tensor, its plain twin
`ops.knn.nn_argmin` on a CPU tensor."""
from .knn import nn_argmin_kernel as nn_argmin  # noqa: F401
