from .app import App, FrameResult  # noqa: F401
from .config import PipelineConfig, load_yaml_config  # noqa: F401
from .sequence import (  # noqa: F401
    SequenceRecorder,
    SequenceRunner,
    synthetic_sequence,
)
