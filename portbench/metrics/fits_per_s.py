"""Seedings completed a second: the lanes of the window's whole requests
over the time from the first request's start to the last one's end (host
clock; each request ends in a synchronise)."""


def read(run):
    answered = run.answered
    if not answered:
        return None
    lanes = sum(len(r.seeds) for r in answered)
    return lanes / (run.requests[-1].t1 - run.requests[0].t0)
