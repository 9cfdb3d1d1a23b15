"""HOT003 corpus for torch's per-call constructors in a @hot_path
function; an undecorated function and a zero-copy view stay silent."""

import torch


def hot_path(bound="batch"):
    # Local stub: the static pass matches the decorator's name.
    def deco(fn):
        return fn
    return deco


@hot_path(bound="batch")
def build(n, rows, parts):
    a = torch.empty(n)  # EXPECT: HOT003
    b = torch.zeros(n)  # EXPECT: HOT003
    c = torch.ones(n)  # EXPECT: HOT003
    d = torch.full((n,), 7)  # EXPECT: HOT003
    e = torch.cat(parts)  # EXPECT: HOT003
    f = torch.stack(parts)  # EXPECT: HOT003
    g = torch.tensor([n])  # EXPECT: HOT003
    view = torch.from_numpy(rows)  # zero-copy: clean
    return a, b, c, d, e, f, g, view


def cold(n):
    return torch.empty(n)  # undecorated: clean


@hot_path(bound="batch")
def reasoned(n):
    return torch.empty(n)  # perfcheck: ignore[HOT003]: the step's output, retained by the caller
