"""The comparison that decides ``correct``, as every kind of unit shares it:
each twist the run samples is worked out again by the kind's plain
reference (``portbench/kinds/<kind>.py`` ``reference``, on
``portbench/reference/``), the kind's ``gaps`` turn the program's answers
and the reference's into numbers, and each number, the worst over the
sampled twists, is held to the cell's limit (``portbench/limits/<cell>.json``).
The reference reads the program's answers only to judge them.
"""

import numpy as np
import torch


def worst(values):
    """The largest of ``values``, NaN if any is NaN (Python's ``max`` would
    pass over a NaN that is not first)."""
    values = [float(v) for v in values]
    return float("nan") if any(v != v for v in values) else max(values)


def in_program_order(prog, ref):
    """``ref``'s orbital energies and amplitudes in the order of the
    program's orbitals, matched by their integer wave vectors (orbitals of
    one kinetic energy may come in either order); None when the two bases
    or occupied sets differ."""
    key = {tuple(n): i for i, n in enumerate(np.asarray(ref["k_int"]))}
    perm = [key.get(tuple(n)) for n in np.asarray(prog["k_int"])]
    no = ref["t2"].shape[-1]
    if (None in perm or len(perm) != len(key)
            or sorted(perm[:no]) != list(range(no))):
        return None
    perm = torch.as_tensor(perm)
    o, v = perm[:no], perm[no:] - no
    return (ref["eps"][perm],
            ref["t2"][v][:, v][:, :, o][:, :, :, o])


def compare(kind, cfg, traffic, twists, answers, records, picks, limits,
            device):
    """(numbers, twists that failed): the kind's numbers, each the worst
    over the problems ``picks``, and the problems whose own numbers fail
    ``limits``."""
    numbers, bad = {}, set()
    for k in picks:
        ref = kind.reference(cfg, traffic, twists[k], device)
        got = kind.gaps(answers[k], ref, records[k])
        del ref
        for name, v in got.items():
            numbers[name] = worst([numbers.get(name, 0.0), v])
        if not judge(got, limits)[0]:
            bad.add(k)
    return numbers, bad


def judge(numbers, limits):
    """(correct, rows): each number beside its limit; correct when every
    number is at or below its limit and none is missing or not finite."""
    rows, ok = {}, True
    for name, lim in limits.items():
        v = numbers.get(name)
        good = v is not None and bool(np.isfinite(v)) and v <= lim
        ok = ok and good
        # JSON has no NaN or infinity: a number that is not finite is null
        rows[name] = {"value": v if v is not None and np.isfinite(v)
                      else None, "limit": lim}
    return ok, rows
