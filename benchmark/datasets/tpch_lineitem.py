"""TPC-H's lineitem table, all 16 of its columns.

Source: TPC-H Specification 2.x, Clause 4.2.3 (the generation rules) and
Clauses 2.4.1 and 2.4.6 (Q1 and Q6). A seeded NumPy generator that follows
Clause 4.2.3; it is not byte-identical to dbgen. Decimals are exact scaled
integers: prices in cents, discount and tax in hundredths. Dates are days
since 1970-01-01.

The program's columns derive from raw draws (part key, quantity, discount,
tax, ship and receipt offsets, the R/A coin); the reference
(reference/tpch_lineitem.py) is handed the raw draws and derives price,
dates and flags itself. The columns that no query reads (keys, line
number, commit date, ship instructions and mode, comment) come from a
stream of their own.
"""

from __future__ import annotations

import numpy as np

from .ssb_flat import rng

START_DAY = int(np.datetime64("1992-01-01").astype(np.int64))
END_DAY = int(np.datetime64("1998-12-31").astype(np.int64))
CURRENT_DAY = int(np.datetime64("1995-06-17").astype(np.int64))
INSTRUCTIONS = ("DELIVER IN PERSON", "COLLECT COD", "NONE",
                "TAKE BACK RETURN")
SHIPMODES = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")
# words of Clause 4.2.2.10's text grammar, from which comments are cut
WORDS = (
    "packages requests accounts deposits foxes ideas theodolites pinto beans "
    "instructions dependencies excuses platelets asymptotes courts dolphins "
    "multipliers sauternes warthogs frets dinos attainments somas Tiresias "
    "patterns forges braids hockey players frays warhorses dugouts notornis "
    "epitaphs pearls tithes waters orbits gifts sheaves depths sentiments "
    "decoys realms pains grouches escapades sleep wake are cajole haggle nag "
    "use boost affix detect integrate maintain nod was lose sublate solve "
    "thrash promise engage hinder print x-ray breach eat grow impress mold "
    "poach serve run dazzle snooze doze unwind kindle play hang believe doubt "
    "furious sly careful blithe quick fluffy slow quiet ruthless thin close "
    "dogged daring brave stealthy permanent enticing idle busy regular final "
    "ironic even bold silent sometimes always never furiously slyly "
    "carefully blithely quickly fluffily slowly quietly ruthlessly thinly "
    "closely doggedly daringly bravely stealthily permanently enticingly "
    "idly busily regularly finally ironically evenly boldly silently about "
    "above according to across after against along alongside of among "
    "around at atop before behind beneath beside besides between beyond by "
    "despite during except for from in place of inside instead of into near "
    "of on outside over past since through throughout to toward under until "
    "up upon without with within do may might shall will would can could "
    "should ought to must will have to shall have to could have to should "
    "have to must have to need to try to . ; : ? ! --").split()
TEXT_CHARS = 1 << 20


def num_chunks(cfg: dict) -> int:
    return cfg["segments"]


def chunk_orders(cfg: dict, i: int) -> int:
    total, k = int(1_500_000 * cfg["scale_factor"]), num_chunks(cfg)
    return total // k + (1 if i < total % k else 0)


def draws(cfg: dict, seed: int, i: int) -> dict:
    """Chunk i's raw draws, in order-key order (Clause 4.2.3): 1 to 7
    lines an order, O_ORDERDATE uniform in [STARTDATE, ENDDATE - 151];
    per line the part (1..SF x 200,000, zero-based here), quantity 1..50,
    discount 0..10, tax 0..8, ship offset 1..121, receipt offset 1..30
    and the R-or-A coin."""
    r = rng(seed, 2, i)
    orders = chunk_orders(cfg, i)
    lines = r.integers(1, 8, orders)
    orderdate = r.integers(START_DAY, END_DAY - 151 + 1, orders,
                           dtype=np.int32)
    rows = int(lines.sum())
    return {"order": np.repeat(np.arange(orders, dtype=np.int32), lines),
            "orderdate": np.repeat(orderdate, lines),
            "partkey": r.integers(0, max(1, int(200_000 * cfg["scale_factor"])),
                                  rows, dtype=np.int32),
            "quantity": r.integers(1, 51, rows, dtype=np.int8),
            "discount": r.integers(0, 11, rows, dtype=np.int8),
            "tax": r.integers(0, 9, rows, dtype=np.int8),
            "ship": r.integers(1, 122, rows, dtype=np.int8),
            "receipt": r.integers(1, 31, rows, dtype=np.int8),
            "coin": r.integers(0, 2, rows, dtype=np.int8)}


def chunk_columns(cfg: dict, seed: int, i: int, dim=None) -> dict:
    """The program's rows of chunk i. P_RETAILPRICE = (90000 + ((key / 10)
    mod 20001) + 100 x (key mod 1000)) / 100 with the one-based key, here
    in cents; L_EXTENDEDPRICE = quantity x that; L_SHIPDATE = orderdate +
    ship offset, L_RECEIPTDATE = shipdate + receipt offset; L_RETURNFLAG
    R or A when the receipt is on or before 1995-06-17, else N;
    L_LINESTATUS O when shipped after it, else F. The other columns come
    from `extras`."""
    d = draws(cfg, seed, i)
    pk = d["partkey"].astype(np.int32) + 1
    price = 90_000 + (pk // 10) % 20_001 + 100 * (pk % 1000)
    ship = d["orderdate"] + d["ship"]
    receipt = ship + d["receipt"]
    flags = np.asarray(["R", "A", "N"], dtype=object)
    status = np.asarray(["F", "O"], dtype=object)
    flag = np.where(receipt <= CURRENT_DAY, d["coin"], 2)
    return {**extras(cfg, seed, i, d),
            "l_receiptdate": receipt.astype(np.int32),
            "l_quantity": d["quantity"].astype(np.int32),
            "l_extendedprice": d["quantity"].astype(np.int32) * price,
            "l_discount": d["discount"].astype(np.int32),
            "l_tax": d["tax"].astype(np.int32),
            "l_shipdate": ship.astype(np.int32),
            "l_returnflag": flags[flag],
            "l_linestatus": status[(ship > CURRENT_DAY).astype(np.int64)]}


def text_pool(seed: int) -> str:
    """Clause 4.2.2.10's text pool, here 1 MiB of the grammar's words in
    a seeded order, from which each comment is a random substring."""
    r = rng(seed, 5)
    words = np.asarray(WORDS, dtype=object)[
        r.integers(0, len(WORDS), TEXT_CHARS // 4)]
    return " ".join(words)[:TEXT_CHARS]


def extras(cfg: dict, seed: int, i: int, d: dict) -> dict:
    """Chunk i's columns that no query reads, from a stream of their own:
    keys (orders numbered from 1 in chunk order; L_SUPPKEY by Clause
    4.2.3's rule from the part key and a draw of 0..3), line numbers,
    L_COMMITDATE 30 to 90 days after the order, instructions, mode, and
    L_COMMENT a substring of the text pool of 10 to 43 characters."""
    r = rng(seed, 6, i)
    rows = len(d["orderdate"])
    first = np.flatnonzero(np.diff(d["order"], prepend=-1))
    lines = np.diff(np.append(first, rows))
    sf = cfg["scale_factor"]
    supp = max(1, int(10_000 * sf))
    pk = d["partkey"].astype(np.int64) + 1
    corner = r.integers(0, 4, rows)
    pool = text_pool(seed)
    offs = r.integers(0, len(pool) - 43, rows)
    lens = r.integers(10, 44, rows)
    return {
        "l_orderkey": (order_offset(cfg, i) + d["order"] + 1).astype(np.int32),
        "l_partkey": pk.astype(np.int32),
        "l_suppkey": ((pk + corner * (supp // 4 + (pk - 1) // supp)) % supp
                      + 1).astype(np.int32),
        "l_linenumber": (np.arange(rows) - np.repeat(first, lines) + 1)
        .astype(np.int32),
        "l_commitdate": (d["orderdate"] + r.integers(30, 91, rows))
        .astype(np.int32),
        "l_shipinstruct": np.asarray(INSTRUCTIONS, dtype=object)[
            r.integers(0, 4, rows)],
        "l_shipmode": np.asarray(SHIPMODES, dtype=object)[
            r.integers(0, 7, rows)],
        "l_comment": np.asarray([pool[o:o + n] for o, n in zip(
            offs.tolist(), lens.tolist())], dtype=object)}


def order_offset(cfg: dict, i: int) -> int:
    """Orders in the chunks before chunk i."""
    return sum(chunk_orders(cfg, j) for j in range(i))


def reference_data(cfg: dict, seed: int) -> dict:
    parts = [draws(cfg, seed, i) for i in range(num_chunks(cfg))]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
