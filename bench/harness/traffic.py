"""The one generator of compile requests, driven by a mix's data file.

A mix (``traffic/<name>.json``) says how the client sends (``"loop":
"closed"``, one client: the next request leaves when the last has
returned), which compile options every request shares (``"options"``; a
value ``{"config": key}`` is the configuration's ``key``), and what varies
from request to request (``"vary"``: a field of the accelerator or of the
compile options, each with a list of values or a ``{"from", "to",
"step"}`` range).  A round is every combination of the varied values; a
run sends round after round, each in an order drawn from the seed, so that
every seed sends the same requests in another order.
"""
from __future__ import annotations

import itertools
import random


def values(spec) -> list:
    if isinstance(spec, dict):
        return list(range(spec["from"], spec["to"] + 1, spec["step"]))
    return list(spec)


def one_round(traffic: dict) -> list[dict]:
    """Every distinct request of the mix, in a fixed order."""
    names = sorted(traffic["vary"])
    return [dict(zip(names, combo)) for combo in
            itertools.product(*(values(traffic["vary"][n]) for n in names))]


def requests(traffic: dict, seed: int):
    """The endless request stream of a seed."""
    if traffic.get("loop") != "closed" or traffic.get("clients", 1) != 1:
        raise ValueError("this generator sends a closed loop of one client")
    rng = random.Random(seed)
    base = one_round(traffic)
    while True:
        order = base[:]
        rng.shuffle(order)
        yield from order


def key(request: dict) -> tuple:
    return tuple(sorted(request.items()))


def options(traffic: dict, config: dict, request: dict,
            hw_fields: dict) -> dict:
    """The compile options of a request (the fields that are not the
    accelerator's)."""
    out = {}
    for name, v in traffic.get("options", {}).items():
        out[name] = config[v["config"]] if isinstance(v, dict) else v
    out.update({k: v for k, v in request.items() if k not in hw_fields})
    return out


def accelerator(config: dict, request: dict) -> dict:
    """The accelerator's fields for a request."""
    fields = dict(config["accelerator"]["fields"])
    fields.update({k: v for k, v in request.items() if k in fields})
    return fields
