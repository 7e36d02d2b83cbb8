"""The one traffic generator: queries drawn from a traffic mix's data file.

A mix (benchmark/traffic/<name>.json) holds the client count, the loop,
a prefix every statement carries, and its templates: each with a weight,
its SQL, the same query as a declarative spec for the reference, and the
domains its literals are drawn from. Parameter kinds, drawn in file order:

    {"int": [lo, hi]}                   uniform, both ends included
    {"choice": [v, ...]}                one of the values; a dict value
                                        sets each of its keys
    {"sample": [v, ...], "names": [..]} distinct values, one per name
    {"linear": [[name, k], ...], "plus": c}
                                        sum of earlier params times k, + c

Each client sends rounds of the templates (each `weight` times a round) in
an order drawn from (seed, client), so every seed sends the same mix in
another order; the literals come from the same stream.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path

from ..datasets.ssb_flat import rng

TRAFFIC_DIR = Path(__file__).resolve().parents[1] / "traffic"
_WHOLE = re.compile(r"^\{(\w+)\}$")


@dataclass(frozen=True)
class Query:
    template: str
    sql: str
    spec: dict
    key: str  # the template and its literals: equal keys, equal answers


def load(name: str) -> dict:
    with open(TRAFFIC_DIR / f"{name}.json") as f:
        return json.load(f)


def draw_params(spec: dict, r) -> dict:
    out: dict = {}
    for name, p in spec.items():
        if "int" in p:
            lo, hi = p["int"]
            out[name] = int(r.integers(lo, hi + 1))
        elif "choice" in p:
            v = p["choice"][int(r.integers(0, len(p["choice"])))]
            if isinstance(v, dict):
                out.update(v)
            else:
                out[name] = v
        elif "sample" in p:
            picks = r.choice(len(p["sample"]), size=len(p["names"]),
                             replace=False)
            for n, k in zip(p["names"], picks):
                out[n] = p["sample"][int(k)]
        elif "linear" in p:
            out[name] = sum(out[n] * k for n, k in p["linear"]) \
                + p.get("plus", 0)
        else:
            raise ValueError(f"parameter {name}: unknown kind {sorted(p)}")
    return out


def render(obj, params: dict):
    """`obj` with every "{name}" string replaced by the value itself and
    every other string formatted with the params."""
    if isinstance(obj, str):
        m = _WHOLE.match(obj)
        if m:
            return params[m.group(1)]
        return obj.format(**params) if "{" in obj else obj
    if isinstance(obj, list):
        return [render(x, params) for x in obj]
    if isinstance(obj, dict):
        return {k: render(v, params) for k, v in obj.items()}
    return obj


def client_queries(traffic: dict, seed: int, client: int):
    """Client `client`'s endless stream of queries."""
    r = rng(seed, 100, client)
    deck = [t for t in traffic["templates"] for _ in range(t["weight"])]
    while True:
        for k in r.permutation(len(deck)):
            t = deck[int(k)]
            params = draw_params(t["params"], r)
            sql = traffic["query_prefix"] + render(t["sql"], params)
            yield Query(t["name"], sql, render(t["reference"], params),
                        t["name"] + json.dumps(params, sort_keys=True))
