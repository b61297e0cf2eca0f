"""Host ms a step in ``Trainer._prepare_maps`` plus ``_prepare_rois``
(which includes the wait for the previous step's candidates), over the
traced run's window."""


def read(run):
    if run.kind != "train" or not run.host_ms.get("_prepare_maps"):
        return None
    maps, rois = run.host_ms["_prepare_maps"], run.host_ms.get("_prepare_rois", [])
    return sum(maps) / len(maps) + (sum(rois) / len(rois) if rois else 0.0)
