"""Host ms a step the preparing thread worked on the next batch: the self
time of the program's ``prep.*`` spans (packing, pinning, roi sampling,
the roi buffer), the wait for the previous step's candidates left out,
over the traced span, in a training cell."""

from gpubench import spans


def read(run):
    return spans.self_ms_per_step(spans.traced(run),
                                  lambda n: n.startswith(spans.PREP) and n != spans.CAND_WAIT)
