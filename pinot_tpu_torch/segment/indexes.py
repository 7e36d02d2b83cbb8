"""Per-column auxiliary indexes: inverted, sorted, range, bloom, JSON,
text, geo and vector.

The port's own copy of pinot_tpu/segment/indexes.py. The bloom filter
prunes segments (engine/pruner.py; written by segment/builder.py and built
at load by segment/loader.py backfill_indexes). The JSON, text and vector
indexes answer JSON_MATCH, TEXT_MATCH and VECTOR_SIMILARITY: those
predicates have no vector form over a column plane, so the planner
evaluates them here, on the host, into a doc mask that rides the device
program as a boolean param plane (engine/host_masks.py, ir.MaskParam). The
inverted, sorted, raw range and geo grid indexes feed the host engine
(engine/host_executor.py), which answers a filter from them instead of a
scan. The buffers are the JAX package's, byte for byte, so a segment
either builder wrote answers the same in both.

The inverted index is CSR over (dictId -> ascending docIds). Posting
lists lie in ascending dictId order, so a dictId range is one contiguous
slice: for dict columns it doubles as the range index. A raw column's
range index is (sorted values, argsort permutation): a value range
binary-searches to one slice of the permutation. The geo index is a
uniform lat/lng grid (the reference's H3 cells; H3 is not a dependency):
candidate cells covering the query circle, then an exact haversine
refinement of their docs.

Reference inventory (SURVEY.md §2.2): BitmapInvertedIndexReader,
BitSlicedRangeIndexReader, SortedIndexReader, bloom/, JsonIndexReader,
the Lucene text index, H3IndexReader, the HNSW vector index
(pinot-segment-local/.../segment/index/readers/).
"""
from __future__ import annotations

import bisect
import json
import re
from dataclasses import dataclass

import numpy as np

from ..utils.sketches import hash64_any

# ---------------------------------------------------------------------------
# Inverted index (CSR): dictId -> sorted docId posting list
# ---------------------------------------------------------------------------


@dataclass
class InvertedIndex:
    offsets: np.ndarray  # u32[card+1]
    docs: np.ndarray     # u32[num_docs] grouped by dictId, ascending docId

    @staticmethod
    def build(dict_ids: np.ndarray, cardinality: int) -> "InvertedIndex":
        # a stable sort keeps docIds ascending within each dictId
        order = np.argsort(dict_ids, kind="stable")
        counts = np.bincount(dict_ids, minlength=cardinality)
        offsets = np.zeros(cardinality + 1, dtype=np.uint32)
        np.cumsum(counts, out=offsets[1:])
        return InvertedIndex(offsets, order.astype(np.uint32))

    def postings(self, dict_id: int) -> np.ndarray:
        return self.docs[self.offsets[dict_id]:self.offsets[dict_id + 1]]

    def postings_range(self, lo_id: int, hi_id: int) -> np.ndarray:
        """Every docId with lo_id <= dictId <= hi_id: one contiguous
        slice."""
        if hi_id < lo_id:
            return self.docs[0:0]
        return self.docs[self.offsets[lo_id]:self.offsets[hi_id + 1]]

    def mask_for_ids(self, ids, num_docs: int) -> np.ndarray:
        m = np.zeros(num_docs, dtype=bool)
        for i in ids:
            m[self.postings(int(i))] = True
        return m

    def mask_for_range(self, lo_id: int, hi_id: int,
                       num_docs: int) -> np.ndarray:
        m = np.zeros(num_docs, dtype=bool)
        m[self.postings_range(lo_id, hi_id)] = True
        return m


# ---------------------------------------------------------------------------
# Raw-column range index: sorted values + permutation
# ---------------------------------------------------------------------------


@dataclass
class RawRangeIndex:
    sorted_values: np.ndarray
    perm: np.ndarray  # u32: sorted_values[i] == raw[perm[i]]

    @staticmethod
    def build(values: np.ndarray) -> "RawRangeIndex":
        perm = np.argsort(values, kind="stable")
        return RawRangeIndex(values[perm], perm.astype(np.uint32))

    def docs_in_range(self, lower, upper, lower_inc=True,
                      upper_inc=True) -> np.ndarray:
        lo = 0
        hi = len(self.sorted_values)
        if lower is not None:
            lo = np.searchsorted(self.sorted_values, lower,
                                 side="left" if lower_inc else "right")
        if upper is not None:
            hi = np.searchsorted(self.sorted_values, upper,
                                 side="right" if upper_inc else "left")
        return self.perm[lo:hi]

    def mask_in_range(self, num_docs: int, lower, upper, lower_inc=True,
                      upper_inc=True):
        m = np.zeros(num_docs, dtype=bool)
        m[self.docs_in_range(lower, upper, lower_inc, upper_inc)] = True
        return m


# ---------------------------------------------------------------------------
# Sorted index: for a sorted dict column, dictId -> contiguous [start, end)
# docId range (the reference's SortedIndexReader reads it off the forward
# index; nothing is stored)
# ---------------------------------------------------------------------------


@dataclass
class SortedIndex:
    # dictId d occupies docs [starts[d], starts[d+1])
    starts: np.ndarray  # u32[card+1]

    @staticmethod
    def build(dict_ids: np.ndarray, cardinality: int) -> "SortedIndex":
        counts = np.bincount(dict_ids, minlength=cardinality)
        starts = np.zeros(cardinality + 1, dtype=np.uint32)
        np.cumsum(counts, out=starts[1:])
        return SortedIndex(starts)

    def doc_range(self, lo_id: int, hi_id: int) -> tuple[int, int]:
        if hi_id < lo_id:
            return (0, 0)
        return int(self.starts[lo_id]), int(self.starts[hi_id + 1])


def serialize_inverted(idx: InvertedIndex) -> list[tuple[str, np.ndarray]]:
    return [("inv.off", idx.offsets), ("inv.docs", idx.docs)]


def deserialize_inverted(off: np.ndarray, docs: np.ndarray) -> InvertedIndex:
    return InvertedIndex(off.view(np.uint32), docs.view(np.uint32))


def serialize_raw_range(idx: RawRangeIndex) -> list[tuple[str, np.ndarray]]:
    return [("rng.sorted", idx.sorted_values), ("rng.perm", idx.perm)]


# ---------------------------------------------------------------------------
# Bloom filter (per-column EQ pruning — reference guava-backed
# BloomFilterSegmentPruner path).
# ---------------------------------------------------------------------------


@dataclass
class BloomFilter:
    bits: np.ndarray  # packed u8, little-endian bit order
    num_bits: int
    num_hashes: int

    @staticmethod
    def build(values, fpp: float = 0.05) -> "BloomFilter":
        """The JAX package's filter over `values`, bit for bit: sized for
        every value, duplicates included, and each distinct hash set once
        (a bit set twice is set once, so hashing the distinct values gives
        the same bits)."""
        vals = _bloom_canon(np.asarray(values))
        n = max(1, len(vals))
        num_bits = max(64, int(-n * np.log(fpp) / (np.log(2) ** 2)))
        num_bits = (num_bits + 7) & ~7
        k = max(1, int(round(num_bits / n * np.log(2))))
        bf = BloomFilter(np.zeros(num_bits // 8, dtype=np.uint8), num_bits, k)
        if vals.dtype.kind == "f":
            # distinct bit patterns: the hash reads the float's bits
            distinct = np.unique(vals.view(np.int64)).view(np.float64)
        else:
            distinct = np.asarray(list(dict.fromkeys(
                str(x) for x in vals.ravel().tolist())), dtype=object)
        pos = bf._positions(hash64_any(distinct)).ravel()
        np.bitwise_or.at(bf.bits, pos >> 3, (1 << (pos & 7)).astype(np.uint8))
        return bf

    def _positions(self, h: np.ndarray) -> np.ndarray:
        h1 = h & np.uint64(0xFFFFFFFF)
        h2 = h >> np.uint64(32)
        ks = np.arange(self.num_hashes, dtype=np.uint64)
        with np.errstate(over="ignore"):
            return ((h1[:, None] + ks[None, :] * h2[:, None])
                    % np.uint64(self.num_bits)).astype(np.int64)

    def might_contain(self, value) -> bool:
        pos = self._positions(
            hash64_any(_bloom_canon(np.asarray([value])))).ravel()
        return bool(np.all((self.bits[pos >> 3] >> (pos & 7)) & 1))


def _bloom_canon(vals: np.ndarray) -> np.ndarray:
    """Numerics hash as float64, so `WHERE fare = 5` (an int literal) finds
    rows of a DOUBLE column and vice versa."""
    if vals.dtype.kind in ("i", "u", "f", "b"):
        return vals.astype(np.float64)
    return vals


def serialize_bloom(bf: BloomFilter) -> list[tuple[str, np.ndarray]]:
    header = np.asarray([bf.num_bits, bf.num_hashes], dtype=np.int64)
    return [("bloom.hdr", header), ("bloom.bits", bf.bits)]


def deserialize_bloom(hdr: np.ndarray, bits: np.ndarray) -> BloomFilter:
    hdr = hdr.view(np.int64)
    return BloomFilter(bits.view(np.uint8), int(hdr[0]), int(hdr[1]))


# ---------------------------------------------------------------------------
# JSON index: flattened path=value -> posting lists
# (reference JsonIndexReader / MutableJsonIndexImpl semantics subset:
# '$.a.b' exact paths, '$.arr[*].k' array wildcards)
# ---------------------------------------------------------------------------


@dataclass
class JsonIndex:
    keys: dict[str, np.ndarray]  # "path\x00value" -> sorted u32 docIds
    paths: dict[str, np.ndarray]  # "path" -> sorted u32 docIds where path exists

    @staticmethod
    def build(json_strings) -> "JsonIndex":
        key_docs: dict[str, list[int]] = {}
        path_docs: dict[str, list[int]] = {}
        for doc_id, s in enumerate(json_strings):
            try:
                obj = json.loads(s) if isinstance(s, str) else s
            except (json.JSONDecodeError, TypeError):
                continue
            seen_keys: set[str] = set()
            seen_paths: set[str] = set()
            _flatten(obj, "$", seen_keys, seen_paths)
            for k in seen_keys:
                key_docs.setdefault(k, []).append(doc_id)
            for p in seen_paths:
                path_docs.setdefault(p, []).append(doc_id)
        return JsonIndex(
            {k: np.asarray(v, dtype=np.uint32) for k, v in key_docs.items()},
            {k: np.asarray(v, dtype=np.uint32) for k, v in path_docs.items()},
        )

    def docs_eq(self, path: str, value) -> np.ndarray:
        return self.keys.get(f"{path}\x00{_canon(value)}",
                             np.empty(0, dtype=np.uint32))

    def docs_exists(self, path: str) -> np.ndarray:
        return self.paths.get(path, np.empty(0, dtype=np.uint32))

    def mask_match(self, expr: str, num_docs: int) -> np.ndarray:
        """Evaluate a JSON_MATCH filter expression string -> doc mask:
        "$.path" = 'v', <>, IN, NOT IN, IS [NOT] NULL and AND/OR/NOT
        combinations of them (MatchAllPredicate etc. are out of scope)."""
        from ..query.filter import FilterContext, FilterNodeType, PredicateType
        from ..query.parser.sql import parse_filter_expression

        f = parse_filter_expression(expr)

        def ev(node: FilterContext) -> np.ndarray:
            if node.type == FilterNodeType.AND:
                m = ev(node.children[0])
                for c in node.children[1:]:
                    m = m & ev(c)
                return m
            if node.type == FilterNodeType.OR:
                m = ev(node.children[0])
                for c in node.children[1:]:
                    m = m | ev(c)
                return m
            if node.type == FilterNodeType.NOT:
                return ~ev(node.children[0])
            if node.type == FilterNodeType.CONSTANT:
                return np.full(num_docs, node.constant_value, dtype=bool)
            p = node.predicate
            path = p.lhs.identifier
            if path is None:
                raise ValueError(f"JSON_MATCH lhs must be a path: {p.lhs}")
            if not path.startswith("$"):
                path = "$." + path
            m = np.zeros(num_docs, dtype=bool)
            if p.type == PredicateType.EQ:
                m[self.docs_eq(path, p.values[0])] = True
            elif p.type == PredicateType.NOT_EQ:
                m[self.docs_exists(path)] = True
                m[self.docs_eq(path, p.values[0])] = False
            elif p.type == PredicateType.IN:
                for v in p.values:
                    m[self.docs_eq(path, v)] = True
            elif p.type == PredicateType.NOT_IN:
                m[self.docs_exists(path)] = True
                for v in p.values:
                    m[self.docs_eq(path, v)] = False
            elif p.type == PredicateType.IS_NOT_NULL:
                m[self.docs_exists(path)] = True
            elif p.type == PredicateType.IS_NULL:
                m[self.docs_exists(path)] = True
                m = ~m
            else:
                raise ValueError(f"JSON_MATCH predicate {p.type} unsupported")
            return m

        return ev(f)


def _canon(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v == int(v):
        return str(int(v))
    return str(v)


def _flatten(obj, prefix: str, keys: set[str], paths: set[str]):
    if isinstance(obj, dict):
        paths.add(prefix)
        for k, v in obj.items():
            _flatten(v, f"{prefix}.{k}", keys, paths)
    elif isinstance(obj, list):
        paths.add(prefix)
        for v in obj:
            _flatten(v, f"{prefix}[*]", keys, paths)
    else:
        paths.add(prefix)
        if obj is None:
            return
        keys.add(f"{prefix}\x00{_canon(obj)}")


def serialize_json_index(idx: JsonIndex) -> list[tuple[str, np.ndarray]]:
    """keys/paths dictionaries -> (utf8 key table, CSR offsets, docs)."""
    out = []
    for field_name, table in (("keys", idx.keys), ("paths", idx.paths)):
        names = sorted(table)
        blob = "\x01".join(names).encode("utf-8")
        offsets = np.zeros(len(names) + 1, dtype=np.uint64)
        if names:
            np.cumsum([len(table[k]) for k in names], out=offsets[1:])
        docs = (np.concatenate([table[k] for k in names]).astype(np.uint32)
                if names else np.empty(0, dtype=np.uint32))
        out.append((f"json.{field_name}.names",
                    np.frombuffer(blob, dtype=np.uint8)))
        out.append((f"json.{field_name}.off", offsets))
        out.append((f"json.{field_name}.docs", docs))
    return out


def deserialize_json_index(bufs: dict[str, np.ndarray]) -> JsonIndex:
    tables = []
    for field_name in ("keys", "paths"):
        blob = bufs[f"json.{field_name}.names"].tobytes().decode("utf-8")
        names = blob.split("\x01") if blob else []
        off = bufs[f"json.{field_name}.off"].view(np.uint64)
        docs = bufs[f"json.{field_name}.docs"].view(np.uint32)
        tables.append({k: docs[off[i]:off[i + 1]] for i, k in enumerate(names)})
    return JsonIndex(*tables)


# ---------------------------------------------------------------------------
# Text index: tokenized terms -> postings with positions (TEXT_MATCH)
# ---------------------------------------------------------------------------

_TOKEN_SPLIT = re.compile(r"[^0-9a-z]+")
# TextIndex.build's byte map: the bytes of tokenize_text's tokens and the
# NUL it joins documents with stay, every other byte becomes a space
_TOKEN_BYTES = bytes(c if chr(c) in "0123456789abcdefghijklmnopqrstuvwxyz\x00"
                     else 32 for c in range(256))


def tokenize_text(s: str) -> list[str]:
    """Lowercase alphanumeric tokenizer (reference: Lucene's
    StandardAnalyzer as configured by the text index's default)."""
    return [t for t in _TOKEN_SPLIT.split(str(s).lower()) if t]


@dataclass
class TextIndex:
    """Term -> (docs, positions) postings for Lucene-ish TEXT_MATCH queries:
    `term`, `a AND b`, `a OR b`, prefix `ab*`, regex `/.../` and `"exact
    phrase"` via positions.

    Reference: the Lucene text index + native FST regex engine
    (pinot-segment-local/.../readers/text/, .../utils/nativefst/). Postings
    are dense numpy arrays; phrase matching intersects (doc, pos) pairs,
    the same approach as Lucene's exact PhraseQuery."""

    terms: list  # sorted term strings
    doc_postings: list  # parallel: np.uint32 doc ids (deduped, sorted)
    pos_postings: list  # parallel: (np.uint32 docs-with-dup, np.uint32 pos)

    @staticmethod
    def build(strings) -> "TextIndex":
        """The JAX package's postings, built from flat arrays: the corpus
        is tokenized in one pass (documents joined by NUL, which no token
        holds), and each token's (term, doc, position), in document order,
        is stably sorted by term, so every term's (doc, pos) pairs keep
        document and position order."""
        strings = list(strings)
        # a NUL inside a document separates tokens like any other non-token
        # character: it must not end the document
        blob = "\x00".join("" if s is None else str(s).replace("\x00", " ")
                            for s in strings)
        # bytes of [0-9a-z] stay, every other byte (a UTF-8 sequence's
        # included) separates, NUL becomes a token of its own
        toks = blob.lower().encode("utf-8").translate(_TOKEN_BYTES).replace(
            b"\x00", b" \x00 ").split()
        vocab = sorted(set(toks) - {b"\x00"})
        terms = [t.decode("ascii") for t in vocab]
        rank = {t: i for i, t in enumerate(vocab)}
        rank[b"\x00"] = -1
        tid = np.fromiter(map(rank.__getitem__, toks),
                          dtype=np.int16 if len(terms) < (1 << 15)
                          else np.int64, count=len(toks))
        sep = tid < 0
        docs = np.cumsum(sep)[~sep]  # separators before each word
        tid = tid[~sep]
        counts = np.bincount(docs, minlength=len(strings))
        pos = np.arange(len(tid), dtype=np.int64) - (
            np.cumsum(counts) - counts)[docs]
        order = np.argsort(tid, kind="stable")
        tid = tid[order]
        docs = docs[order].astype(np.uint32)
        pos = pos[order].astype(np.uint32)
        off = np.zeros(len(terms) + 1, dtype=np.int64)
        np.cumsum(np.bincount(tid, minlength=len(terms)), out=off[1:])
        pos_postings = [(docs[off[i]:off[i + 1]], pos[off[i]:off[i + 1]])
                        for i in range(len(terms))]
        doc_postings = _doc_postings(docs, off)
        return TextIndex(terms, doc_postings, pos_postings)

    # -- term lookups -------------------------------------------------------
    def _term_index(self, term: str) -> int:
        i = bisect.bisect_left(self.terms, term)
        return i if i < len(self.terms) and self.terms[i] == term else -1

    def docs_for_term(self, term: str) -> np.ndarray:
        i = self._term_index(term)
        return self.doc_postings[i] if i >= 0 else np.empty(0, dtype=np.uint32)

    def _prefix_range(self, prefix: str) -> tuple[int, int]:
        """[lo, hi) slice of sorted terms starting with prefix."""
        lo = bisect.bisect_left(self.terms, prefix)
        hi = bisect.bisect_left(self.terms, prefix + "￿")
        return lo, hi

    def docs_for_prefix(self, prefix: str) -> np.ndarray:
        lo, hi = self._prefix_range(prefix)
        if lo >= hi:
            return np.empty(0, dtype=np.uint32)
        return np.unique(np.concatenate(self.doc_postings[lo:hi]))

    def docs_for_regex(self, pattern: str) -> np.ndarray:
        """Docs containing any term matching the regex (reference: the
        native FST regex engine walks the term automaton,
        .../utils/nativefst/RegexpMatcher.java). The sorted term list plays
        the FST's role: a literal prefix extracted from the pattern narrows
        the scan to one bisect range before the full-match test."""
        # terms are lowercased by the analyzer: match case-insensitively so
        # /Error.*/ behaves like every other (lowercased) query form
        pat = re.compile(pattern, re.IGNORECASE)
        # a char is a REQUIRED literal only if it is alphanumeric and no
        # following quantifier makes it optional or repeated (errors? has
        # the literal prefix "error"); top-level alternation voids any
        # prefix
        prefix = []
        if "|" not in pattern:
            for i, ch in enumerate(pattern):
                nxt = pattern[i + 1] if i + 1 < len(pattern) else ""
                if ch.isalnum() and nxt not in "?*{":
                    prefix.append(ch.lower())
                else:
                    break
        lo, hi = (self._prefix_range("".join(prefix)) if prefix
                  else (0, len(self.terms)))
        parts = [self.doc_postings[i] for i in range(lo, hi)
                 if pat.fullmatch(self.terms[i])]
        if not parts:
            return np.empty(0, dtype=np.uint32)
        return np.unique(np.concatenate(parts))

    # -- relevance (reference: Lucene BM25Similarity backing the text
    # index's match scores) -------------------------------------------------
    def bm25_scores(self, query: str, num_docs: int,
                    k1: float = 1.2, b: float = 0.75) -> np.ndarray:
        """BM25 score per doc for the flat terms of a TEXT_MATCH query
        (phrases/prefixes score by their expanded terms)."""
        terms = self._score_terms(_parse_text_query(query))
        doc_len = np.zeros(num_docs, dtype=np.float64)
        for docs_dup, _pos in self.pos_postings:
            np.add.at(doc_len, docs_dup[docs_dup < num_docs], 1.0)
        avg_len = doc_len.mean() if num_docs else 1.0
        avg_len = avg_len or 1.0
        scores = np.zeros(num_docs, dtype=np.float64)
        for term in terms:
            i = self._term_index(term)
            if i < 0:
                continue
            docs_dup, _ = self.pos_postings[i]
            docs_dup = docs_dup[docs_dup < num_docs]
            tf = np.zeros(num_docs, dtype=np.float64)
            np.add.at(tf, docs_dup, 1.0)
            df = len(self.doc_postings[i])
            idf = np.log1p((num_docs - df + 0.5) / (df + 0.5))
            denom = tf + k1 * (1 - b + b * doc_len / avg_len)
            with np.errstate(invalid="ignore", divide="ignore"):
                contrib = idf * tf * (k1 + 1) / np.where(denom == 0, 1, denom)
            scores += np.where(tf > 0, contrib, 0.0)
        return scores

    def _score_terms(self, node) -> list:
        kind = node[0]
        if kind == "term":
            return [node[1]]
        if kind == "phrase":
            return list(node[1])
        if kind == "prefix":
            lo, hi = self._prefix_range(node[1])
            return self.terms[lo:hi]
        if kind == "regex":
            pat = re.compile(node[1], re.IGNORECASE)
            return [t for t in self.terms if pat.fullmatch(t)]
        if kind in ("and", "or"):
            out = []
            for c in node[1]:
                out.extend(self._score_terms(c))
            return out
        return []

    def docs_for_phrase(self, phrase_terms: list) -> np.ndarray:
        """Docs containing the terms at consecutive positions: the JAX
        package's intersection of (doc, position - k) pairs, each pair one
        int64 (doc << 32 | the uint32 position) so numpy intersects them."""
        if not phrase_terms:
            return np.empty(0, dtype=np.uint32)
        i = self._term_index(phrase_terms[0])
        if i < 0:
            return np.empty(0, dtype=np.uint32)
        docs, pos = self.pos_postings[i]
        cur = _pairs(docs, pos)
        for k, term in enumerate(phrase_terms[1:], start=1):
            j = self._term_index(term)
            if j < 0:
                return np.empty(0, dtype=np.uint32)
            d2, p2 = self.pos_postings[j]
            cur = np.intersect1d(cur, _pairs(d2, p2 - k))
            if not len(cur):
                return np.empty(0, dtype=np.uint32)
        return np.unique((cur >> 32).astype(np.uint32))

    # -- query --------------------------------------------------------------
    def mask_match(self, query: str, num_docs: int) -> np.ndarray:
        """Evaluate a TEXT_MATCH query into a doc mask."""
        docs = self._eval_query(_parse_text_query(query))
        mask = np.zeros(num_docs, dtype=bool)
        if len(docs):
            mask[docs[docs < num_docs]] = True
        return mask

    def _eval_query(self, node) -> np.ndarray:
        kind = node[0]
        if kind == "term":
            return self.docs_for_term(node[1])
        if kind == "prefix":
            return self.docs_for_prefix(node[1])
        if kind == "regex":
            return self.docs_for_regex(node[1])
        if kind == "phrase":
            return self.docs_for_phrase(node[1])
        if kind == "and":
            out = None
            for child in node[1]:
                d = self._eval_query(child)
                out = d if out is None else np.intersect1d(out, d)
            return out if out is not None else np.empty(0, dtype=np.uint32)
        if kind == "or":
            parts = [self._eval_query(c) for c in node[1]]
            parts = [p for p in parts if len(p)]
            return (np.unique(np.concatenate(parts)) if parts
                    else np.empty(0, dtype=np.uint32))
        if kind == "not":
            raise ValueError("NOT requires an enclosing AND in TEXT_MATCH")
        raise ValueError(f"bad text query node {node!r}")


def _pairs(docs: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """(doc, uint32 position) pairs as sortable int64 keys."""
    return (docs.astype(np.int64) << 32) | pos.astype(np.uint32).astype(
        np.int64)


def _doc_postings(docs: np.ndarray, off: np.ndarray) -> list:
    """Each term's distinct docs from the postings docs[off[i]:off[i + 1]],
    which both builders store in document order (np.unique per term)."""
    first = np.ones(len(docs), dtype=bool)
    first[1:] = docs[1:] != docs[:-1]
    starts = off[:-1][off[:-1] < len(docs)].astype(np.int64)
    first[starts] = True
    if np.any((docs[1:] < docs[:-1]) & ~first[1:]):
        raise ValueError("text index postings are not in document order")
    uniq = docs[first]
    uoff = np.concatenate([[0], np.cumsum(first)])[off.astype(np.int64)]
    return [uniq[uoff[i]:uoff[i + 1]] for i in range(len(off) - 1)]


def _parse_text_query(q: str):
    """Mini Lucene syntax: terms, quoted phrases, AND/OR (AND binds
    tighter), prefix `foo*`, regex `/.../`, parentheses. Bare adjacency =
    OR (Lucene's default operator)."""
    # regex terms /.../ lex as ONE token: their parens/operators are part
    # of the pattern, not the boolean query
    tokens = re.findall(r'"[^"]*"|/(?:[^/\\]|\\.)+/|\(|\)|[^\s()"]+', q)
    pos = [0]

    def peek():
        return tokens[pos[0]] if pos[0] < len(tokens) else None

    def next_tok():
        t = peek()
        pos[0] += 1
        return t

    def parse_or():
        parts = [parse_and()]
        while peek() is not None and peek() not in (")",):
            if peek().upper() == "OR":
                next_tok()
                parts.append(parse_and())
            elif peek().upper() == "AND":
                break
            else:
                parts.append(parse_and())  # adjacency = OR
        return parts[0] if len(parts) == 1 else ("or", parts)

    def parse_and():
        parts = [parse_primary()]
        while peek() is not None and peek().upper() == "AND":
            next_tok()
            parts.append(parse_primary())
        return parts[0] if len(parts) == 1 else ("and", parts)

    def parse_primary():
        t = next_tok()
        if t is None:
            raise ValueError("empty TEXT_MATCH query")
        if t == "(":
            inner = parse_or()
            if next_tok() != ")":
                raise ValueError("unbalanced parens in TEXT_MATCH")
            return inner
        if t.startswith('"'):
            return ("phrase", tokenize_text(t.strip('"')))
        if t.startswith("/") and t.endswith("/") and len(t) > 1:
            # Lucene regex term syntax /pattern/
            return ("regex", t[1:-1])
        if t.endswith("*"):
            return ("prefix", t[:-1].lower())
        toks = tokenize_text(t)
        if len(toks) == 1:
            return ("term", toks[0])
        return ("phrase", toks)

    out = parse_or()
    if pos[0] != len(tokens):
        raise ValueError(f"trailing input in TEXT_MATCH query {q!r}")
    return out


def serialize_text_index(idx: TextIndex) -> list[tuple[str, np.ndarray]]:
    blob = "\x01".join(idx.terms).encode("utf-8")
    off = np.zeros(len(idx.terms) + 1, dtype=np.uint64)
    if idx.terms:
        np.cumsum([len(d) for d, _ in idx.pos_postings], out=off[1:])
    cat = (np.concatenate([d for d, _ in idx.pos_postings]).astype(np.uint32)
           if idx.terms else np.empty(0, np.uint32))
    pcat = (np.concatenate([p for _, p in idx.pos_postings]).astype(np.uint32)
            if idx.terms else np.empty(0, np.uint32))
    return [("text.terms", np.frombuffer(blob, dtype=np.uint8)),
            ("text.off", off), ("text.docs", cat), ("text.pos", pcat)]


def deserialize_text_index(bufs: dict[str, np.ndarray]) -> TextIndex:
    blob = bufs["text.terms"].tobytes().decode("utf-8")
    terms = blob.split("\x01") if blob else []
    off = bufs["text.off"].view(np.uint64)
    docs = bufs["text.docs"].view(np.uint32)
    pos = bufs["text.pos"].view(np.uint32)
    pos_postings = [(docs[off[i]:off[i + 1]], pos[off[i]:off[i + 1]])
                    for i in range(len(terms))]
    return TextIndex(terms, _doc_postings(docs, off[:len(terms) + 1]),
                     pos_postings)


# ---------------------------------------------------------------------------
# Geo grid index (the H3 analogue): lat/lng cells -> postings
# ---------------------------------------------------------------------------

EARTH_RADIUS_M = 6371008.8


def haversine_m(lat1, lng1, lat2, lng2):
    """Great-circle distance in meters (vectorized)."""
    lat1, lng1, lat2, lng2 = (np.radians(np.asarray(x, dtype=np.float64))
                              for x in (lat1, lng1, lat2, lng2))
    dlat = lat2 - lat1
    dlng = lng2 - lng1
    a = np.sin(dlat / 2) ** 2 \
        + np.cos(lat1) * np.cos(lat2) * np.sin(dlng / 2) ** 2
    return 2 * EARTH_RADIUS_M * np.arcsin(np.sqrt(np.clip(a, 0, 1)))


@dataclass
class GeoGridIndex:
    """Fixed-resolution lat/lng grid cells -> doc postings.

    Reference: the H3 hexagon index (H3IndexReader and
    H3InclusionIndexFilterOperator): the candidate cells that cover the
    query circle, then an exact haversine refinement of their docs only.
    Cells here are a uniform grid of `res_deg` degrees."""

    res_deg: float
    cell_ids: np.ndarray  # sorted unique int64 cell ids
    offsets: np.ndarray   # CSR into docs
    docs: np.ndarray

    @staticmethod
    def cell_of(lat: np.ndarray, lng: np.ndarray,
                res_deg: float) -> np.ndarray:
        r = np.int64(np.ceil(360.0 / res_deg))
        n_lat = np.int64(np.ceil(180.0 / res_deg))
        la = np.floor((np.asarray(lat, dtype=np.float64) + 90.0)
                      / res_deg).astype(np.int64)
        la = np.minimum(la, n_lat - 1)  # lat=+90 lands in the top row
        lo = np.floor((np.asarray(lng, dtype=np.float64) + 180.0)
                      / res_deg).astype(np.int64)
        lo = lo % r  # lng=+180 is the meridian of -180
        return la * r + lo

    @staticmethod
    def build(lat: np.ndarray, lng: np.ndarray,
              res_deg: float = 0.5) -> "GeoGridIndex":
        cells = GeoGridIndex.cell_of(lat, lng, res_deg)
        order = np.argsort(cells, kind="stable")
        uniq, starts = np.unique(cells[order], return_index=True)
        offsets = np.append(starts, len(cells)).astype(np.uint64)
        return GeoGridIndex(res_deg, uniq.astype(np.int64), offsets,
                            order.astype(np.uint32))

    def candidate_docs(self, lat: float, lng: float,
                       radius_m: float) -> np.ndarray:
        """Docs in the cells that meet the circle (a superset of the
        matches)."""
        deg_lat = np.degrees(radius_m / EARTH_RADIUS_M)
        cos = max(0.01, np.cos(np.radians(lat)))
        deg_lng = deg_lat / cos
        r = np.int64(np.ceil(360.0 / self.res_deg))
        n_lat = int(np.ceil(180.0 / self.res_deg))
        la_lo = int(np.floor((lat - deg_lat + 90.0) / self.res_deg))
        la_hi = int(np.floor((lat + deg_lat + 90.0) / self.res_deg))
        pole_clip = la_lo < 0 or la_hi >= n_lat  # the circle reaches a pole
        la_lo, la_hi = max(la_lo, 0), min(la_hi, n_lat - 1)
        lo_lo = int(np.floor((lng - deg_lng + 180.0) / self.res_deg))
        lo_hi = int(np.floor((lng + deg_lng + 180.0) / self.res_deg))
        if pole_clip or lo_hi - lo_lo + 1 >= int(r):
            lo_cols = np.arange(r, dtype=np.int64)  # every longitude
        else:
            # modulo the grid's width: a circle across +-180 degrees keeps
            # its cells
            lo_cols = np.arange(lo_lo, lo_hi + 1, dtype=np.int64) % r
        wanted = np.concatenate([np.int64(la) * r + lo_cols
                                 for la in range(la_lo, la_hi + 1)])
        idx = np.searchsorted(self.cell_ids, wanted)
        idx = idx[idx < len(self.cell_ids)]
        hit = idx[np.isin(self.cell_ids[idx], wanted)]
        if not len(hit):
            return np.empty(0, dtype=np.uint32)
        return np.concatenate([self.docs[self.offsets[i]:self.offsets[i + 1]]
                               for i in np.unique(hit)])


def serialize_geo_index(idx: GeoGridIndex) -> list[tuple[str, np.ndarray]]:
    hdr = np.asarray([idx.res_deg], dtype=np.float64)
    return [("geo.hdr", hdr), ("geo.cells", idx.cell_ids),
            ("geo.off", idx.offsets), ("geo.docs", idx.docs)]


def deserialize_geo_index(bufs: dict[str, np.ndarray]) -> GeoGridIndex:
    return GeoGridIndex(float(bufs["geo.hdr"].view(np.float64)[0]),
                        bufs["geo.cells"].view(np.int64),
                        bufs["geo.off"].view(np.uint64),
                        bufs["geo.docs"].view(np.uint32))


# ---------------------------------------------------------------------------
# Vector index: exact cosine top-K + IVF pruning
# ---------------------------------------------------------------------------


@dataclass
class VectorIndex:
    """Top-K cosine similarity over a (n, dim) float32 matrix.

    Reference: the Lucene HNSW vector index (pinot-segment-local/.../
    creator/impl/vector/lucene99/, VectorSimilarityFilterOperator). As in
    the JAX package, the vectors are stored L2-normalized and densely, the
    similarity is one (n, dim) x (dim,) product, and an IVF coarse quantizer
    (k-means centroids) prunes to nprobe clusters for large segments. It
    runs on the host: its result is a doc mask (engine/host_masks.py)."""

    vectors: np.ndarray  # (n, dim) float32, L2-normalized rows
    centroids: np.ndarray = None  # (nlist, dim) or None
    assignments: np.ndarray = None  # (n,) int32 cluster of each row

    @staticmethod
    def build(vectors: np.ndarray, nlist: int = 0) -> "VectorIndex":
        v = np.ascontiguousarray(vectors, dtype=np.float32)
        norms = np.linalg.norm(v, axis=1, keepdims=True)
        norms[norms == 0] = 1.0
        v = v / norms
        centroids = assignments = None
        n = len(v)
        if nlist == 0 and n >= 4096:
            nlist = int(np.sqrt(n))
        if nlist > 1 and n > nlist:
            centroids, assignments = _kmeans(v, nlist)
        return VectorIndex(v, centroids, assignments)

    def top_k(self, query: np.ndarray, k: int, nprobe: int = 8):
        """(doc_ids, similarities) of the k nearest by cosine."""
        q = np.asarray(query, dtype=np.float32)
        qn = np.linalg.norm(q)
        if qn > 0:
            q = q / qn
        if self.centroids is not None and nprobe < len(self.centroids):
            cscore = self.centroids @ q
            probe = np.argpartition(cscore, -nprobe)[-nprobe:]
            cand = np.nonzero(np.isin(self.assignments, probe))[0]
            if len(cand) < k:  # under-probed: fall back to exact
                cand = np.arange(len(self.vectors))
        else:
            cand = np.arange(len(self.vectors))
        sims = self.vectors[cand] @ q
        k = min(k, len(cand))
        if k == 0:
            return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.float32)
        top = np.argpartition(sims, -k)[-k:]
        order = np.argsort(-sims[top], kind="stable")
        sel = top[order]
        return cand[sel].astype(np.int64), sims[sel]

    def mask_top_k(self, query: np.ndarray, k: int, num_docs: int) -> np.ndarray:
        docs, _ = self.top_k(query, k)
        mask = np.zeros(num_docs, dtype=bool)
        mask[docs[docs < num_docs]] = True
        return mask


def _kmeans(v: np.ndarray, nlist: int, iters: int = 8):
    """Small k-means on normalized vectors (IVF coarse quantizer): the JAX
    package's, from the same default_rng(0), so the centroids and the
    assignments are the same bits."""
    rng = np.random.default_rng(0)
    centroids = v[rng.choice(len(v), nlist, replace=False)].copy()
    assign = np.zeros(len(v), dtype=np.int32)
    for _ in range(iters):
        assign = np.argmax(v @ centroids.T, axis=1).astype(np.int32)
        for c in range(nlist):
            members = v[assign == c]
            if len(members):
                m = members.mean(axis=0)
                norm = np.linalg.norm(m)
                centroids[c] = m / norm if norm > 0 else m
    return centroids, assign


def serialize_vector_index(idx: VectorIndex) -> list[tuple[str, np.ndarray]]:
    n, dim = idx.vectors.shape
    nlist = 0 if idx.centroids is None else len(idx.centroids)
    hdr = np.asarray([n, dim, nlist], dtype=np.int64)
    out = [("vec.hdr", hdr), ("vec.data", idx.vectors.reshape(-1))]
    if nlist:
        out.append(("vec.centroids", idx.centroids.reshape(-1)))
        out.append(("vec.assign", idx.assignments))
    return out


def deserialize_vector_index(bufs: dict[str, np.ndarray]) -> VectorIndex:
    n, dim, nlist = (int(x) for x in bufs["vec.hdr"].view(np.int64))
    vecs = bufs["vec.data"].view(np.float32).reshape(n, dim)
    if nlist:
        return VectorIndex(vecs,
                           bufs["vec.centroids"].view(np.float32).reshape(nlist, dim),
                           bufs["vec.assign"].view(np.int32))
    return VectorIndex(vecs)
