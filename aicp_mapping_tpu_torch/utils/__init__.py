from .timing import TimingUtils, profiler_trace  # noqa: F401
from .visualizer import (  # noqa: F401
    FileVisualizer,
    NullVisualizer,
    RecordingVisualizer,
    Visualizer,
)
