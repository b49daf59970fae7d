"""setup_s: seconds from the start of the process to the start of the
window: imports, CUDA and the kernels (built on a first run), the scene,
the App, the bootstrap and the warm-up frames."""


def read(run):
    return run.setup_s if run.window is not None else None
