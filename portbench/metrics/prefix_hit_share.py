"""Share of the prompt tokens admitted in the window that came from the
prefix cache: the batcher's ``prefix_hits`` (pages) gained in the window,
times the page size, over the prompt tokens the provider encoded in it."""


def read(run):
    s0, s1 = run.info.get("stats0"), run.info.get("stats1")
    if not s0 or "prefix_hits" not in s0:
        return None
    tokens = sum(n for t, n in run.info["encoded"] if run.w0 <= t < run.w1)
    if not tokens:
        return None
    return 100.0 * (s1["prefix_hits"] - s0["prefix_hits"]) * run.info["page_size"] / tokens
