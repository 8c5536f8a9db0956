"""Time of the engines' ``apply_placement`` a slice, each call between
two synchronizes (the benchmark's wrapper), summed over a slice, mean
over the window's slices."""


def read(run):
    xs = run.spans.get("migration_slice")
    return sum(xs) / len(xs) * 1e3 if xs else None
