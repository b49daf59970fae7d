"""icp_iterations: the mean of `FrameResult.n_iterations` over the
registered frames of the staged and traced segments, iterations a frame."""


def read(run):
    frames = [run.results[k] for k in run.staged + run.traced
              if k < len(run.results) and run.results[k].registered]
    if not frames:
        return None
    return sum(r.n_iterations for r in frames) / len(frames)
