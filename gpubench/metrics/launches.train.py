"""The host's kernel and graph launch calls (``cudaLaunchKernel*``,
``cudaGraphLaunch``) a step over the traced span, in a training cell."""


def read(run):
    if run.kind != "train" or run.window is None or not run.span.spanned:
        return None
    return run.window.launches / run.span.spanned
