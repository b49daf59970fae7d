"""Map-scale localization, PyTorch port of the single-device part of
`aicp_mapping_tpu.parallel`. The mesh, the sharded ICP, the pose graph and
bundle adjustment are not ported yet (ROADMAP Q1 #12-#13)."""
from .localizer import ShardedMapLocalizer, morton_argsort_np  # noqa: F401
