"""Host ms a batch in box decode and NMS
(``get_boxes_from_candidates_batch`` as the pipeline calls it, after the
candidates' copy has landed), over the traced run's window."""


def read(run):
    if run.kind != "serve" or run.hooks is None or not run.hooks.nms_ms:
        return None
    return sum(run.hooks.nms_ms) / len(run.hooks.nms_ms)
