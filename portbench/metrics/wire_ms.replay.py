"""wire_ms.replay: the host clock around each `wire_batch` call on the
runner's preparation thread over the staged frames, per cloud, ms."""
from portbench.metrics._spans import mean_ms


def read(run):
    return mean_ms(run, "wire_batch_per_cloud")
