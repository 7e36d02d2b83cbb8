"""The plain reference of TPC-H lineitem.

It is handed the raw draws (datasets/tpch_lineitem.py `reference_data`)
and derives price, ship and receipt dates and the two flags itself by
Clause 4.2.3, on `device`. The queries are answered by
reference/engine.py. Nothing of the program is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..datasets.tpch_lineitem import CURRENT_DAY
from .engine import Source


def source(cfg: dict, data: dict, device) -> Source:
    dev = torch.device(device)

    def t(name):
        return torch.from_numpy(np.ascontiguousarray(data[name])).to(dev) \
            .long()

    def ship():
        return t("orderdate") + t("ship")

    def extendedprice():
        key = t("partkey") + 1
        return t("quantity") * (90_000 + (key // 10) % 20_001
                                + 100 * (key % 1000))

    def returnflag():
        receipt = ship() + t("receipt")
        return (torch.where(receipt <= CURRENT_DAY, t("coin"), 2),
                ["R", "A", "N"])

    builders = {
        "l_quantity": lambda: t("quantity"),
        "l_extendedprice": extendedprice,
        "l_discount": lambda: t("discount"),
        "l_tax": lambda: t("tax"),
        "l_shipdate": ship,
        "l_returnflag": returnflag,
        "l_linestatus": lambda: ((ship() > CURRENT_DAY).long(), ["F", "O"]),
    }
    return Source(len(data["orderdate"]), builders)
