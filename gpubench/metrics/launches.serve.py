"""The host's kernel and graph launch calls (``cudaLaunchKernel*``,
``cudaGraphLaunch``) a batch over the traced span, in a serving cell."""


def read(run):
    if run.kind != "serve" or run.window is None or not run.span.spanned:
        return None
    return run.window.launches / run.span.spanned
