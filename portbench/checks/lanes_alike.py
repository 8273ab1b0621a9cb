"""How many lanes of the window's requests are not a seeding of their own:
in each request, the pairs of lanes whose index sequences are identical
(lanes that share a solve or a generator), and the lanes missing from, or
added to, the seeds the request asked for.  Two lanes of distinct seeds
share a first center with a chance of about 1 in n, and all k centers in
order with a chance of about 0: an exact comparison, limit 0."""


def compute(ctx):
    answered = [r for r in ctx.requests if r.error is None]
    if not answered:
        return None
    out = 0
    for r in answered:
        out += abs(len(r.indices) - len(r.seeds))
        seen = {}
        for idx in r.indices:
            key = idx.tobytes()
            out += seen.get(key, 0)
            seen[key] = seen.get(key, 0) + 1
    return out
