"""The Star Schema Benchmark's data, flattened into one lineorder table.

Source: P. O'Neil, E. O'Neil, X. Chen, S. Revilak, "The Star Schema
Benchmark and Augmented Fact Table Indexing", TPCTC 2009 (the table sizes
and value domains of its section 2, as ssb-dbgen writes them), in the
denormalised `lineorder_flat` layout of ClickHouse's SSB guide.

A seeded NumPy generator that follows the spec's sizes and domains; it is
not byte-identical to dbgen. The star is drawn first (customer, supplier,
part and date dimensions, then lineorder chunk by chunk), and the program's
flat rows are the star joined: every column of ClickHouse's lineorder_flat
(the 17 of LINEORDER, 7 of CUSTOMER and SUPPLIER less their keys, 8 of
PART less its key) and the four date attributes the queries read. The
reference (reference/ssb_flat.py) joins the same star itself, so a fault
in the flattening reads as a wrong answer.

Every array is a function of (seed, stream) alone, so the build workers
and the reference draw the same rows without passing them around.
"""

from __future__ import annotations

import math

import numpy as np

# TPC-H's 25 nations with their regions (TPC-H spec 4.2.3), which SSB keeps
NATIONS = (
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4), ("JAPAN", 2),
    ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0), ("MOZAMBIQUE", 0),
    ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3), ("SAUDI ARABIA", 4),
    ("VIETNAM", 2), ("RUSSIA", 3), ("UNITED KINGDOM", 3),
    ("UNITED STATES", 1))
REGIONS = ("AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST")
MONTHS = ("Jan", "Feb", "Mar", "Apr", "May", "Jun", "Jul", "Aug", "Sep",
          "Oct", "Nov", "Dec")
FIRST_DAY = np.datetime64("1992-01-01")
PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")
SHIPMODES = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")
SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD")
# TPC-H's P_NAME words (Clause 4.2.3), which SSB's P_NAME and P_COLOR use
COLORS = (
    "almond antique aquamarine azure beige bisque black blanched blue blush "
    "brown burlywood burnished chartreuse chiffon chocolate coral cornflower "
    "cornsilk cream cyan dark deep dim dodger drab firebrick floral forest "
    "frosted gainsboro ghost goldenrod green grey honeydew hot indian ivory "
    "khaki lace lavender lawn lemon light lime linen magenta maroon medium "
    "metallic midnight mint misty moccasin navajo navy olive orange orchid "
    "pale papaya peach peru pink plum powder puff purple red rose rosy royal "
    "saddle salmon sandy seashell sienna sky slate smoke snow spring steel "
    "tan thistle tomato turquoise violet wheat white yellow").split()
TYPES = tuple(f"{a} {b} {c}"
              for a in ("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY",
                        "PROMO")
              for b in ("ANODIZED", "BURNISHED", "PLATED", "POLISHED",
                        "BRUSHED")
              for c in ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER"))
CONTAINERS = tuple(f"{a} {b}" for a in ("SM", "LG", "MED", "JUMBO", "WRAP")
                   for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK",
                             "CAN", "DRUM"))
ADDRESS_CHARS = np.frombuffer(
    b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789 ,.",
    dtype=np.uint8)


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one stream of a seed: any whole number, negative
    ones folded into 64 bits."""
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence(
        [int(seed) & ((1 << 64) - 1), *stream])))


def sizes(cfg: dict) -> dict:
    """Row counts of the star at the config's scale factor (SSB section 2):
    customer 30,000 x SF, supplier 2,000 x SF, part 200,000 x
    floor(1 + log2 SF), 1,500,000 x SF orders."""
    sf = cfg["scale_factor"]
    return {"customer": max(1, int(30_000 * sf)),
            "supplier": max(1, int(2_000 * sf)),
            "part": 200_000 * max(1, int(1 + math.log2(sf))),
            "orders": int(1_500_000 * sf)}


def num_chunks(cfg: dict) -> int:
    return cfg["segments"]


def city_names() -> list:
    """The 250 cities: a nation's name cut or padded to 9 characters and a
    digit (dbgen's `UNITED KI1`, `CHINA    4`)."""
    return [f"{name[:9]:<9}{d}" for name, _ in NATIONS for d in range(10)]


def date_table(cfg: dict) -> dict:
    """The date dimension's columns the queries read, by date index."""
    days = FIRST_DAY + np.arange(cfg["date_days"])
    years = days.astype("datetime64[Y]").astype(np.int64) + 1970
    months = days.astype("datetime64[M]").astype(np.int64) % 12 + 1
    doy = (days - days.astype("datetime64[Y]")).astype(np.int64) + 1
    return {"datekey": ((years * 100 + months) * 100
                        + (days - days.astype("datetime64[M]")).astype(
                            np.int64) + 1).astype(np.int32),
            "year": years.astype(np.int32),
            "yearmonthnum": (years * 100 + months).astype(np.int32),
            "month": months.astype(np.int32),
            "weeknuminyear": ((doy - 1) // 7 + 1).astype(np.int32)}


def dims(cfg: dict, seed: int) -> dict:
    """The dimensions: each customer's and supplier's city code (nation *
    10 + digit), each part's brand (category * 100 + 1..40, category =
    mfgr * 10 + 1..5) and price in cents (TPC-H's P_RETAILPRICE rule)."""
    n = sizes(cfg)
    r = rng(seed, 0)
    c_city = r.integers(0, 25, n["customer"]) * 10 + r.integers(
        0, 10, n["customer"])
    s_city = r.integers(0, 25, n["supplier"]) * 10 + r.integers(
        0, 10, n["supplier"])
    mfgr = r.integers(1, 6, n["part"])
    category = mfgr * 10 + r.integers(1, 6, n["part"])
    brand = category * 100 + r.integers(1, 41, n["part"])
    pk = np.arange(1, n["part"] + 1, dtype=np.int64)
    price = 90_000 + (pk // 10) % 20_001 + 100 * (pk % 1000)
    return {"c_city": c_city.astype(np.int16), "s_city": s_city.astype(np.int16),
            "p_brand": brand.astype(np.int16), "p_price": price.astype(np.int32)}


def chunk_orders(cfg: dict, i: int) -> int:
    """Orders in chunk i of dbgen's `-C segments` split."""
    total, k = sizes(cfg)["orders"], num_chunks(cfg)
    return total // k + (1 if i < total % k else 0)


def facts(cfg: dict, seed: int, i: int) -> dict:
    """Chunk i of lineorder as keys and line attributes, in order-key
    order: 1 to 7 lines an order; an order's customer and date (uniform
    over the first `order_days` dates, dbgen's STARTDATE to ENDDATE - 151);
    each line's part, supplier, quantity 1..50 and discount 0..10."""
    n = sizes(cfg)
    r = rng(seed, 1, i)
    orders = chunk_orders(cfg, i)
    lines = r.integers(1, 8, orders)
    cust = r.integers(0, n["customer"], orders, dtype=np.int32)
    date = r.integers(0, cfg["order_days"], orders, dtype=np.int16)
    rows = int(lines.sum())
    starts = np.cumsum(lines) - lines
    return {"linenumber": (np.arange(rows) - np.repeat(starts, lines) + 1)
            .astype(np.int8),
            "custkey": np.repeat(cust, lines),
            "datekey": np.repeat(date, lines),
            "partkey": r.integers(0, n["part"], rows, dtype=np.int32),
            "suppkey": r.integers(0, n["supplier"], rows, dtype=np.int32),
            "quantity": r.integers(1, 51, rows, dtype=np.int8),
            "discount": r.integers(0, 11, rows, dtype=np.int8)}


def _objects(values) -> np.ndarray:
    return np.asarray(list(values), dtype=object)


def chunk_columns(cfg: dict, seed: int, i: int, dim: dict | None = None) -> dict:
    """The program's rows of chunk i: the star joined into the flat
    columns of the config's schema. Strings are object arrays that share
    one str per distinct value. lo_extendedprice = quantity x price,
    lo_revenue = extendedprice x (100 - discount) / 100, lo_supplycost =
    6 x price / 10 (cents, integer division, as dbgen); lo_ordtotalprice
    the sum of its order's lines' extendedprice x (100 - discount) x (100
    + tax) / 10,000. Dates are yyyymmdd. The columns no query reads come
    from `strings` and `line_extras`."""
    dim = dims(cfg, seed) if dim is None else dim
    f = facts(cfg, seed, i)
    dt = date_table(cfg)
    cities = _objects(city_names())
    nations = _objects(name for name, _ in NATIONS)
    region_of = np.asarray([reg for _, reg in NATIONS])
    regions = _objects(REGIONS)
    yearmonth = _objects(f"{MONTHS[m - 1]}{y}"
                         for y, m in zip(dt["year"], dt["month"]))
    d = f["datekey"]
    c = dim["c_city"][f["custkey"]]
    s = dim["s_city"][f["suppkey"]]
    b = dim["p_brand"][f["partkey"]].astype(np.int32)
    price = dim["p_price"][f["partkey"]]
    qty = f["quantity"].astype(np.int32)
    disc = f["discount"].astype(np.int32)
    ext = qty * price
    mfgr = _objects(f"MFGR#{k}" for k in range(10))
    cat = _objects(f"MFGR#{k}" for k in range(60))
    brand = _objects(f"MFGR#{k}" for k in range(6000))
    rev = ext * (100 - disc) // 100
    x = line_extras(cfg, seed, i, f["linenumber"])
    txt = strings(cfg, seed)
    total = ext.astype(np.int64) * (100 - disc) * (100 + x["tax"]) // 10_000
    first = np.flatnonzero(f["linenumber"] == 1)
    per_order = np.add.reduceat(total, first) if len(first) else total
    lines = np.diff(np.append(first, len(total)))
    ck, sk, pk = f["custkey"], f["suppkey"], f["partkey"]
    return {
        "lo_orderkey": (order_offset(cfg, i) + np.repeat(
            np.arange(len(first)), lines) + 1).astype(np.int32),
        "lo_linenumber": f["linenumber"].astype(np.int32),
        "lo_custkey": ck + 1, "lo_partkey": pk + 1, "lo_suppkey": sk + 1,
        "lo_orderdate": dt["datekey"][d],
        "lo_orderpriority": _objects(PRIORITIES)[x["priority"]],
        "lo_shippriority": np.zeros(len(d), dtype=np.int32),
        "lo_ordtotalprice": np.repeat(per_order, lines).astype(np.int32),
        "lo_tax": x["tax"].astype(np.int32),
        "lo_commitdate": dt["datekey"][d + x["commit"]],
        "lo_shipmode": _objects(SHIPMODES)[x["shipmode"]],
        "c_name": txt["c_name"][ck], "c_address": txt["c_address"][ck],
        "c_phone": txt["c_phone"][ck],
        "c_mktsegment": txt["c_mktsegment"][ck],
        "s_name": txt["s_name"][sk], "s_address": txt["s_address"][sk],
        "s_phone": txt["s_phone"][sk],
        "p_name": txt["p_name"][pk], "p_color": txt["p_color"][pk],
        "p_type": txt["p_type"][pk], "p_size": txt["p_size"][pk],
        "p_container": txt["p_container"][pk],
        "d_year": dt["year"][d], "d_yearmonthnum": dt["yearmonthnum"][d],
        "d_yearmonth": yearmonth[d], "d_weeknuminyear": dt["weeknuminyear"][d],
        "c_city": cities[c], "c_nation": nations[c // 10],
        "c_region": regions[region_of[c // 10]],
        "s_city": cities[s], "s_nation": nations[s // 10],
        "s_region": regions[region_of[s // 10]],
        "p_mfgr": mfgr[b // 1000], "p_category": cat[b // 100],
        "p_brand1": brand[b],
        "lo_discount": disc, "lo_quantity": qty,
        "lo_extendedprice": ext,
        "lo_revenue": rev,
        "lo_supplycost": 6 * price // 10,
    }


def order_offset(cfg: dict, i: int) -> int:
    """Orders in the chunks before chunk i."""
    return sum(chunk_orders(cfg, j) for j in range(i))


def line_extras(cfg: dict, seed: int, i: int, linenumber) -> dict:
    """Chunk i's line attributes that no query reads, from a stream of
    their own: each order's priority, and each line's tax 0..8, commit
    date 30 to 90 days after its order's, and ship mode."""
    r = rng(seed, 4, i)
    rows = len(linenumber)
    first = np.flatnonzero(linenumber == 1)
    lines = np.diff(np.append(first, rows))
    return {"priority": np.repeat(r.integers(0, 5, len(first)), lines),
            "tax": r.integers(0, 9, rows, dtype=np.int8),
            "commit": r.integers(30, 91, rows, dtype=np.int16),
            "shipmode": r.integers(0, 7, rows, dtype=np.int8)}


def _addresses(r, n: int) -> np.ndarray:
    """n random addresses of 10 to 25 characters (dbgen's V-string)."""
    chars = ADDRESS_CHARS[r.integers(0, len(ADDRESS_CHARS), (n, 25))]
    lens = r.integers(10, 26, n)
    flat = chars.tobytes()
    return _objects(flat[25 * k:25 * k + lens[k]].decode("ascii")
                    for k in range(n))


def _phones(r, nation: np.ndarray) -> np.ndarray:
    """dbgen's phone numbers: the nation's code (10 + its number), then
    three groups of random digits."""
    n = len(nation)
    a, b, c = (r.integers(100, 1000, n), r.integers(100, 1000, n),
               r.integers(1000, 10000, n))
    return _objects(f"{10 + int(k)}-{x}-{y}-{z}"
                    for k, x, y, z in zip(nation, a, b, c))


def strings(cfg: dict, seed: int) -> dict:
    """The dimensions' attributes that no query reads, by zero-based key,
    from a stream of their own: names, addresses and phones of customers
    and suppliers, a customer's market segment, a part's name (two colour
    words), colour, type, size and container."""
    n = sizes(cfg)
    r = rng(seed, 3)
    dim = dims(cfg, seed)
    pc = r.integers(0, len(COLORS), (n["part"], 2))
    colors = _objects(COLORS)
    return {
        "c_name": _objects(f"Customer#{k + 1:09d}"
                           for k in range(n["customer"])),
        "c_address": _addresses(r, n["customer"]),
        "c_phone": _phones(r, dim["c_city"] // 10),
        "c_mktsegment": _objects(SEGMENTS)[r.integers(0, 5, n["customer"])],
        "s_name": _objects(f"Supplier#{k + 1:09d}"
                           for k in range(n["supplier"])),
        "s_address": _addresses(r, n["supplier"]),
        "s_phone": _phones(r, dim["s_city"] // 10),
        "p_name": _objects(f"{COLORS[a]} {COLORS[b]}" for a, b in pc),
        "p_color": colors[pc[:, 0]],
        "p_type": _objects(TYPES)[r.integers(0, len(TYPES), n["part"])],
        "p_size": r.integers(1, 51, n["part"]).astype(np.int32),
        "p_container": _objects(CONTAINERS)[
            r.integers(0, len(CONTAINERS), n["part"])],
    }


def reference_data(cfg: dict, seed: int) -> dict:
    """What the reference is handed: the dimensions and every chunk's
    facts, concatenated in chunk order."""
    parts = [facts(cfg, seed, i) for i in range(num_chunks(cfg))]
    out = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    out.update(dims(cfg, seed))
    return out
