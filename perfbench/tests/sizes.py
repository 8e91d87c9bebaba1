"""Tiny forms of each configuration, for the CPU tests."""

import copy

from perfbench import datagen


def tiny(name: str) -> dict:
    """A configuration at a size a CPU test holds: fewer slices and
    rows under the same laws; the TopN frame's rank cache still holds
    fewer than a slice's rows over 1.1, as at full size."""
    cfg = copy.deepcopy(datagen.load(name))
    if name == "c4_segments":
        cfg["slices"] = 3
        cfg["frames"]["f"]["rows"] = 64
        cfg["frames"]["f"]["bits"].update(lo=0.002, hi=0.03)
    elif name == "c3_topn":
        cfg["slices"] = 2
        cfg["frames"]["f"]["rows"] = 2400
        cfg["frames"]["f"]["options"]["cacheSize"] = 800
        cfg["frames"]["f"]["bits"]["total"] = 120000
    else:
        raise KeyError(name)
    return cfg
