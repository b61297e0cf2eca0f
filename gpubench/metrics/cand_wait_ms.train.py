"""Host ms a step the preparing thread waited for the previous step's roi
candidates to reach the host (the program's ``prep.wait_candidates``
span), over the traced span, in a training cell."""

from gpubench import spans


def read(run):
    return spans.self_ms_per_step(spans.traced(run), lambda n: n == spans.CAND_WAIT)
