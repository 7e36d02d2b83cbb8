"""The plain reference of the SSB flat table: the star joined here.

It is handed the generated star (datasets/ssb_flat.py `reference_data`:
each line's customer, supplier, part and date keys, quantity and discount,
and the dimension tables) and derives every flat column from it by its own
gathers and arithmetic, on `device`. The queries are answered by
reference/engine.py. Nothing of the program is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..datasets.ssb_flat import (MONTHS, NATIONS, REGIONS, city_names,
                                 date_table)
from .engine import Source


def source(cfg: dict, data: dict, device) -> Source:
    dev = torch.device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    dt = date_table(cfg)
    region_of = t(np.asarray([r for _, r in NATIONS], dtype=np.int64))
    date = t(data["datekey"]).long()
    cust_city = t(data["c_city"]).long()
    supp_city = t(data["s_city"]).long()
    brand = t(data["p_brand"]).long()
    price = t(data["p_price"]).long()
    ym_domain = [f"{MONTHS[m - 1]}{y}" for y, m in zip(dt["year"], dt["month"])]
    cache = {}

    def keyed(name, table, key):
        def build():
            if name not in cache:
                cache[name] = table[t(data[key]).long()]
            return cache[name]
        return build

    c_city = keyed("c_city", cust_city, "custkey")
    s_city = keyed("s_city", supp_city, "suppkey")
    p_brand = keyed("p_brand", brand, "partkey")
    p_price = keyed("p_price", price, "partkey")

    def ext():
        return t(data["quantity"]).long() * p_price()

    names = [n for n, _ in NATIONS]
    builders = {
        "d_year": lambda: t(dt["year"])[date],
        "d_yearmonthnum": lambda: t(dt["yearmonthnum"])[date],
        "d_yearmonth": lambda: (date, ym_domain),
        "d_weeknuminyear": lambda: t(dt["weeknuminyear"])[date],
        "c_city": lambda: (c_city(), city_names()),
        "c_nation": lambda: (c_city() // 10, names),
        "c_region": lambda: (region_of[c_city() // 10], list(REGIONS)),
        "s_city": lambda: (s_city(), city_names()),
        "s_nation": lambda: (s_city() // 10, names),
        "s_region": lambda: (region_of[s_city() // 10], list(REGIONS)),
        "p_mfgr": lambda: (p_brand() // 1000,
                           [f"MFGR#{k}" for k in range(10)]),
        "p_category": lambda: (p_brand() // 100,
                               [f"MFGR#{k}" for k in range(60)]),
        "p_brand1": lambda: (p_brand(), [f"MFGR#{k}" for k in range(6000)]),
        "lo_quantity": lambda: t(data["quantity"]).long(),
        "lo_discount": lambda: t(data["discount"]).long(),
        "lo_extendedprice": ext,
        "lo_revenue": lambda: ext() * (100 - t(data["discount"]).long())
        // 100,
        "lo_supplycost": lambda: 6 * p_price() // 10,
    }
    return Source(len(data["datekey"]), builders)
