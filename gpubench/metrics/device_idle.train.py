"""Percent of the traced span with no kernel, copy or memset on the card
(the union of the device's intervals), in a training cell."""


def read(run):
    if run.kind != "train" or run.window is None:
        return None
    return 100.0 * (1.0 - run.window.busy_s / run.window.window_s)
