"""Time of one engine ``decode`` call between two synchronizes (the
benchmark's wrapper), mean over the window's calls."""


def read(run):
    xs = run.spans.get("decode")
    return sum(xs) / len(xs) * 1e3 if xs else None
