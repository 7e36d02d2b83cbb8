"""CLP-style log-message encoding.

The port's copy of pinot_tpu/segment/clp.py; its buffer layout is the JAX
package's byte for byte. Reference: the CLP forward index
(pinot-segment-local/.../creator/impl/fwd/CLPForwardIndexCreatorV1.java,
built on the CLP paper's insight): machine logs are a small set of
TEMPLATES with variable tokens spliced in. A message splits into

    logtype   - the template with placeholders (\\x11 dict var, \\x12 int,
                \\x13 float); template cardinality is tiny -> dictionary id
    dictVars  - variable tokens containing letters (task_12, /api/v2/users)
    encVars   - pure numeric tokens, kept as their literal text

so "Task task_12 failed after 3.50s" becomes
logtype "Task \\x11 failed after \\x13s", dictVars [task_12], encVars [3.50].
Selected with `compressionConfigs: {col: "CLP"}` on a no-dictionary
STRING column; decoding gives back the exact original strings.

The JAX package encodes and decodes with a loop per row. Here a column
encodes each distinct message once (logtype and variable ids still come
in the order of first appearance, so the bytes are the same), and each
template is parsed once for decoding and the rows of one template are
assembled together, slot by slot; `decode_docs` decodes only the rows
asked for.
"""

from __future__ import annotations

import re
import struct

import numpy as np

ESC = "\x10"
DICT_VAR = "\x11"
INT_VAR = "\x12"
FLOAT_VAR = "\x13"
_SPECIALS = (ESC, DICT_VAR, INT_VAR, FLOAT_VAR)


def _esc(text: str) -> str:
    """Escape placeholder bytes occurring LITERALLY in log text (real CLP
    escapes them too) so decode can't mistake them for variable slots."""
    if not any(ch in text for ch in _SPECIALS):
        return text
    return "".join(ESC + ch if ch in _SPECIALS else ch for ch in text)

# a variable token: contains at least one digit; split on whitespace-ish
# boundaries the same way CLP's tokenizer does
_TOKEN_RE = re.compile(r"[^\s=:,;()\[\]{}\"']+")
_INT_RE = re.compile(r"[-+]?\d+\Z")
_FLOAT_RE = re.compile(r"[-+]?\d*\.\d+\Z")
_HAS_DIGIT_RE = re.compile(r"\d")


def encode_message(msg: str) -> tuple[str, list[str], list[tuple[str, str]]]:
    """→ (logtype, dict_vars, enc_vars as (kind, literal))."""
    out = []
    dict_vars: list[str] = []
    enc_vars: list[tuple[str, str]] = []
    pos = 0
    for m in _TOKEN_RE.finditer(msg):
        tok = m.group(0)
        if not _HAS_DIGIT_RE.search(tok):
            continue
        if _INT_RE.match(tok):
            kind, ph = "i", INT_VAR
        elif _FLOAT_RE.match(tok):
            kind, ph = "f", FLOAT_VAR
        else:
            kind, ph = None, DICT_VAR
        out.append(_esc(msg[pos:m.start()]))
        out.append(ph)
        pos = m.end()
        if kind is None:
            dict_vars.append(tok)
        else:
            enc_vars.append((kind, tok))
    out.append(_esc(msg[pos:]))
    return "".join(out), dict_vars, enc_vars


def decode_message(logtype: str, dict_vars: list[str],
                   enc_vars: list[tuple[str, str]]) -> str:
    out = []
    di = ei = 0
    i, n = 0, len(logtype)
    while i < n:
        ch = logtype[i]
        if ch == ESC and i + 1 < n:
            out.append(logtype[i + 1])  # escaped literal placeholder byte
            i += 2
            continue
        if ch == DICT_VAR:
            out.append(dict_vars[di])
            di += 1
        elif ch in (INT_VAR, FLOAT_VAR):
            out.append(enc_vars[ei][1])
            ei += 1
        else:
            out.append(ch)
        i += 1
    return "".join(out)


class ClpColumn:
    """Encoded form of one string column."""

    def __init__(self, logtypes, type_ids, var_dict, var_ids, var_offsets,
                 enc_blob, enc_offsets):
        self.logtypes = logtypes        # list[str] templates, first-seen order
        self.type_ids = type_ids        # (n,) int32 template id per doc
        self.var_dict = var_dict        # list[str] unique dict vars
        self.var_ids = var_ids          # flat int32 dict-var ids
        self.var_offsets = var_offsets  # (n+1,) int64 into var_ids
        self.enc_blob = enc_blob        # numeric tokens joined by NUL
        self.enc_offsets = enc_offsets  # (n+1,) int64 into the token list
        self.num_docs = len(type_ids)
        self._templates = self._vars = self._tokens = None

    def _parsed(self):
        """(templates, dict vars, numeric tokens): each template as its
        literal pieces and the kind of each slot between them (True for a
        dict var), as decode_message walks it; the dict vars and the split
        token list as object arrays; all made once."""
        if self._templates is None:
            self._vars = np.asarray(self.var_dict, dtype=object)
            self._tokens = np.asarray(
                self.enc_blob.split("\x00") if self.enc_blob else [],
                dtype=object)
            self._templates = [_parse_template(lt) for lt in self.logtypes]
        return self._templates, self._vars, self._tokens

    def decode_all(self) -> np.ndarray:
        return self.decode_docs(np.arange(self.num_docs))

    def decode_docs(self, doc_ids) -> np.ndarray:
        """The original strings of `doc_ids`, an object array. The docs of
        one template have one slot layout, so they are assembled together,
        slot by slot."""
        templates, var_dict, tokens = self._parsed()
        docs = np.asarray(doc_ids, dtype=np.int64).ravel()
        tids = self.type_ids[docs]
        out = np.empty(len(docs), dtype=object)
        for t in np.unique(tids).tolist():
            sel = np.nonzero(tids == t)[0]
            pieces, kinds = templates[t]
            acc = np.full(len(sel), pieces[0], dtype=object)
            vi = self.var_offsets[docs[sel]]
            ei = self.enc_offsets[docs[sel]]
            for is_dict, piece in zip(kinds, pieces[1:]):
                if is_dict:
                    acc = acc + var_dict[self.var_ids[vi]]
                    vi = vi + 1
                else:
                    acc = acc + tokens[ei]
                    ei = ei + 1
                if piece:
                    acc = acc + piece
            out[sel] = acc
        return out


def _parse_template(logtype: str) -> tuple[list[str], list[bool]]:
    pieces, kinds, buf = [], [], []
    i, n = 0, len(logtype)
    while i < n:
        ch = logtype[i]
        if ch == ESC and i + 1 < n:
            buf.append(logtype[i + 1])  # an escaped literal placeholder
            i += 2
            continue
        if ch == DICT_VAR or ch in (INT_VAR, FLOAT_VAR):
            pieces.append("".join(buf))
            buf = []
            kinds.append(ch == DICT_VAR)
        else:
            buf.append(ch)
        i += 1
    pieces.append("".join(buf))
    return pieces, kinds


def encode_column(values) -> ClpColumn:
    n = len(values)
    # each distinct message once, in the order of first appearance, so
    # templates and dict vars get the ids a loop over the rows gives
    first: dict[str, int] = {}
    inv = np.fromiter((first.setdefault("" if v is None else str(v),
                                        len(first)) for v in values),
                      dtype=np.int64, count=n)
    lt_index: dict[str, int] = {}
    vd_index: dict[str, int] = {}
    u_tid, u_vids, u_enc, u_ne = [], [], [], []
    for msg in first:
        lt, dvars, evars = encode_message(msg)
        u_tid.append(lt_index.setdefault(lt, len(lt_index)))
        u_vids.append([vd_index.setdefault(t, len(vd_index)) for t in dvars])
        u_enc.append("\x00".join(literal for _kind, literal in evars))
        u_ne.append(len(evars))
    u_nv = np.asarray([len(v) for v in u_vids], dtype=np.int64)
    u_voff = np.zeros(len(u_vids) + 1, dtype=np.int64)
    np.cumsum(u_nv, out=u_voff[1:])
    u_flat = np.fromiter((i for v in u_vids for i in v), dtype=np.int32,
                         count=int(u_voff[-1]))
    type_ids = np.asarray(u_tid, dtype=np.int32)[inv] if n \
        else np.empty(0, dtype=np.int32)
    var_counts = u_nv[inv]
    var_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(var_counts, out=var_offsets[1:])
    # doc d's vars: its message's run of u_flat, back to back
    total = int(var_offsets[-1])
    within = np.arange(total, dtype=np.int64) - np.repeat(
        var_offsets[:-1], var_counts)
    var_ids = u_flat[np.repeat(u_voff[:-1][inv], var_counts) + within]
    enc_counts = np.asarray(u_ne, dtype=np.int64)[inv] if n \
        else np.zeros(0, dtype=np.int64)
    enc_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(enc_counts, out=enc_offsets[1:])
    u_enc_arr = np.asarray(u_enc, dtype=object)
    enc_blob = "\x00".join(u_enc_arr[inv[enc_counts > 0]].tolist())
    return ClpColumn(list(lt_index), type_ids, list(vd_index), var_ids,
                     var_offsets, enc_blob, enc_offsets)


# -- buffer (de)serialization -------------------------------------------------


def _pack_strs(strs: list[str]) -> bytes:
    """Length-prefixed strings — tokens may contain ANY byte (including
    NUL), so a delimiter-based join would corrupt them."""
    out = bytearray(struct.pack("<I", len(strs)))
    for s in strs:
        b = s.encode("utf-8")
        out += struct.pack("<I", len(b)) + b
    return bytes(out)


class _Rd:
    def __init__(self, b):
        self.b = b
        self.p = 0

    def take(self, n):
        out = self.b[self.p:self.p + n]
        self.p += n
        return out


def _unpack_strs(r: _Rd) -> list[str]:
    (count,) = struct.unpack("<I", r.take(4))
    out = []
    for _ in range(count):
        (n,) = struct.unpack("<I", r.take(4))
        out.append(bytes(r.take(n)).decode("utf-8"))
    return out


def serialize_clp(col: ClpColumn) -> bytes:
    out = bytearray()
    out += _pack_strs(col.logtypes)
    out += _pack_strs(col.var_dict)
    enc = col.enc_blob.encode("utf-8")
    out += struct.pack("<Q", len(enc)) + enc
    for arr, dtype in ((col.type_ids, np.int32), (col.var_ids, np.int32),
                       (col.var_offsets, np.int64), (col.enc_offsets, np.int64)):
        a = np.ascontiguousarray(arr, dtype=dtype)
        out += struct.pack("<Q", a.size) + a.tobytes()
    return bytes(out)


def deserialize_clp(blob: bytes) -> ClpColumn:
    r = _Rd(memoryview(blob))
    logtypes = _unpack_strs(r)
    var_dict = _unpack_strs(r)
    (elen,) = struct.unpack("<Q", r.take(8))
    enc_blob = bytes(r.take(elen)).decode("utf-8")
    arrays = []
    for dtype in (np.int32, np.int32, np.int64, np.int64):
        (n,) = struct.unpack("<Q", r.take(8))
        arrays.append(np.frombuffer(r.take(n * np.dtype(dtype).itemsize),
                                    dtype=dtype))
    type_ids, var_ids, var_offsets, enc_offsets = arrays
    return ClpColumn(logtypes, type_ids, var_dict, var_ids, var_offsets,
                     enc_blob, enc_offsets)
