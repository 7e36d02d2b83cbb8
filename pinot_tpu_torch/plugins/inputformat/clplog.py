"""CLP log-message input format (the port of
pinot_tpu/plugins/inputformat/clplog.py).

Reference: pinot-plugins/pinot-input-format/pinot-clp-log —
CLPLogRecordExtractor.java splits every configured message field F of an
ingested log event into three columns

    F_logtype        STRING       the message template
    F_dictionaryVars ARRAY STRING variable tokens with letters
    F_encodedVars    ARRAY LONG   numeric tokens packed into 64-bit words

(other fields pass through untouched), so log tables group/filter on tiny
logtype dictionaries instead of raw messages. The template split reuses this
repo's CLP tokenizer (segment/clp.py); the 64-bit numeric-variable packing
below is our own reversible scheme (sign/digit-count/point-position/digits),
with the same fallback contract as the reference: any token the packing
cannot represent losslessly is demoted to a dictionary variable.

Config keys (camelCase accepted for reference parity):
    fields_for_clp_encoding: list[str] — fields to CLP-encode (default: none,
        every field passes through)
"""

from __future__ import annotations

from typing import Iterator, Optional

from ...segment import clp as _clp
from ...segment.clp import decode_message, encode_message
from .readers import JsonRecordReader, register_record_reader

_TAG_FLOAT = 1
# float word layout: [1 | sign:1 | ndigits:5 | point:5 | digits:51]
_MAX_DIGITS = 15  # 10^15 < 2^51


def encode_var_to_long(kind: str, literal: str) -> Optional[int]:
    """Pack one numeric token into a reversible int64, or None if the token
    cannot round-trip (caller demotes it to a dictionary variable)."""
    if kind == "i":
        try:
            v = int(literal)
        except ValueError:
            return None
        if not -(1 << 62) <= v < (1 << 62) or str(v) != literal:
            return None  # "+3" / "007" would not reconstruct
        return v << 1
    # float literal: sign? digits '.' digits — reconstruct the exact string
    s = literal
    neg = s.startswith("-")
    if neg:
        s = s[1:]
    if "." not in s:
        return None
    point = s.index(".")
    digits = s.replace(".", "")
    if not digits.isdigit() or len(digits) > _MAX_DIGITS:
        return None
    m = int(digits)
    word = (_TAG_FLOAT | (1 << 1 if neg else 0) | (len(digits) << 2)
            | (point << 7) | (m << 12))
    if long_to_encoded_var(word)[1] != literal:
        return None
    return word


def long_to_encoded_var(word: int) -> tuple[str, str]:
    """Inverse of encode_var_to_long → (kind, literal)."""
    if not word & _TAG_FLOAT:
        return "i", str(word >> 1)
    neg = bool(word & 2)
    nd = (word >> 2) & 0x1F
    point = (word >> 7) & 0x1F
    digits = str(word >> 12).rjust(nd, "0")
    lit = digits[:point] + "." + digits[point:]
    return "f", ("-" + lit) if neg else lit


def encode_field(message: str) -> tuple[str, list[str], list[int]]:
    """One message → (logtype, dictionaryVars, encodedVars). Walks the
    template's placeholders in order, packing each numeric slot; a token the
    packing cannot represent losslessly demotes to a dictionary-variable
    slot (the same fallback the reference's extractor applies when CLP
    encoding fails)."""
    logtype, dict_vars, enc_vars = encode_message(message)
    out: list[str] = []
    new_dict: list[str] = []
    words: list[int] = []
    di, ei = iter(dict_vars), iter(enc_vars)
    i, n = 0, len(logtype)
    while i < n:
        ch = logtype[i]
        if ch == _clp.ESC and i + 1 < n:
            out.append(logtype[i:i + 2])
            i += 2
            continue
        if ch == _clp.DICT_VAR:
            out.append(ch)
            new_dict.append(next(di))
        elif ch in (_clp.INT_VAR, _clp.FLOAT_VAR):
            kind, lit = next(ei)
            w = encode_var_to_long(kind, lit)
            if w is None:
                out.append(_clp.DICT_VAR)
                new_dict.append(lit)
            else:
                out.append(ch)
                words.append(w)
        else:
            out.append(ch)
        i += 1
    return "".join(out), new_dict, words


def decode_field(logtype: str, dict_vars: list[str],
                 encoded_vars: list[int]) -> str:
    """Reassemble the original message from the three split columns."""
    return decode_message(
        logtype, list(dict_vars),
        [long_to_encoded_var(int(w)) for w in encoded_vars])


class ClpLogRecordReader(JsonRecordReader):
    """JSON log reader (lines or top-level array, inherited) applying the
    CLP field split per record (reference: CLPLogMessageDecoder delegating
    to CLPLogRecordExtractor)."""

    def _fields(self) -> list[str]:
        cfg = self.config or {}
        return list(cfg.get("fields_for_clp_encoding")
                    or cfg.get("fieldsForClpEncoding") or [])

    def _iter(self) -> Iterator[dict]:
        fields = self._fields()
        for record in super()._iter():
            yield extract_record(record, fields)


def extract_record(record: dict, fields: list[str]) -> dict:
    """Apply the CLP split to one decoded record (the reference extractor's
    per-record contract: selected fields become the three split columns,
    everything else passes through)."""
    out = {}
    for k, v in record.items():
        if k in fields:
            # null messages still emit the split columns (empty template)
            # so every row carries the same schema
            lt, dv, ev = encode_field("" if v is None else str(v))
            out[f"{k}_logtype"] = lt
            out[f"{k}_dictionaryVars"] = dv
            out[f"{k}_encodedVars"] = ev
        else:
            out[k] = v
    return out


register_record_reader("clplog", ClpLogRecordReader)
register_record_reader("clp", ClpLogRecordReader)
