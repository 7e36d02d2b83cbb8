"""PEP 249 (DB-API 2.0) interface over the broker REST surface (the
port's copy of pinot_tpu/dbapi.py, over the port's client.py).

Reference analogue: pinot-clients/pinot-jdbc-client — the standard-driver
face of the query engine (JDBC for the JVM world, DB-API for Python). A
``Connection``/``Cursor`` pair over client.py's HTTP connection, with the
standard exception hierarchy, ``description`` metadata, fetch* methods,
and qmark-style parameter binding with SQL-literal escaping.

    import pinot_tpu_torch.dbapi as dbapi
    conn = dbapi.connect("http://localhost:8099")
    cur = conn.cursor()
    cur.execute("SELECT team, SUM(runs) FROM stats WHERE year > ? "
                "GROUP BY team", (2000,))
    print(cur.description)
    rows = cur.fetchall()
"""

from __future__ import annotations

from typing import Any, Iterator, Optional, Sequence

from .client import Connection as _HttpConnection
from .client import PinotClientError

apilevel = "2.0"
threadsafety = 2  # threads may share the module and connections
paramstyle = "qmark"


# -- exception hierarchy (PEP 249) -------------------------------------------


class Warning(Exception):  # noqa: A001 — name mandated by PEP 249
    pass


class Error(Exception):
    pass


class InterfaceError(Error):
    pass


class DatabaseError(Error):
    pass


class DataError(DatabaseError):
    pass


class OperationalError(DatabaseError):
    pass


class IntegrityError(DatabaseError):
    pass


class InternalError(DatabaseError):
    pass


class ProgrammingError(DatabaseError):
    pass


class NotSupportedError(DatabaseError):
    pass


# -- parameter binding --------------------------------------------------------


def _quote(value: Any) -> str:
    if value is None:
        return "NULL"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, (list, tuple)):
        return "(" + ", ".join(_quote(v) for v in value) + ")"
    return "'" + str(value).replace("'", "''") + "'"


def _bind(sql: str, params: Optional[Sequence]) -> str:
    if params is None:
        return sql
    out = []
    it = iter(params)
    in_str = False
    i = 0
    while i < len(sql):
        ch = sql[i]
        if ch == "'":
            in_str = not in_str
            out.append(ch)
        elif ch == "?" and not in_str:
            try:
                out.append(_quote(next(it)))
            except StopIteration:
                raise ProgrammingError("not enough parameters for query")
        else:
            out.append(ch)
        i += 1
    leftovers = sum(1 for _ in it)
    if leftovers:
        raise ProgrammingError(f"{leftovers} unused parameters")
    return "".join(out)


# -- type codes ---------------------------------------------------------------

STRING = "STRING"
NUMBER = "NUMBER"
DATETIME = "DATETIME"
BINARY = "BINARY"
ROWID = "ROWID"

_TYPE_MAP = {
    "INT": NUMBER, "LONG": NUMBER, "FLOAT": NUMBER, "DOUBLE": NUMBER,
    "BIG_DECIMAL": NUMBER, "BOOLEAN": NUMBER, "TIMESTAMP": DATETIME,
    "STRING": STRING, "JSON": STRING, "BYTES": BINARY,
}


class Cursor:
    arraysize = 1

    def __init__(self, connection: "Connection"):
        self._conn = connection
        self._rows: list[list] = []
        self._pos = 0
        self.description: Optional[list[tuple]] = None
        self.rowcount = -1

    # -- execution ---------------------------------------------------------
    def execute(self, operation: str, parameters: Optional[Sequence] = None):
        self._check_open()
        sql = _bind(operation, parameters)
        try:
            rs = self._conn._http.execute(sql)
        except PinotClientError as e:
            raise OperationalError(str(e)) from None
        self._rows = list(rs)
        self._pos = 0
        self.rowcount = len(self._rows)
        self.description = [
            (name, _TYPE_MAP.get(ctype, STRING), None, None, None, None, None)
            for name, ctype in zip(rs.column_names, rs.column_types)]
        return self

    def executemany(self, operation: str, seq_of_parameters):
        for params in seq_of_parameters:
            self.execute(operation, params)
        return self

    # -- fetching ----------------------------------------------------------
    def fetchone(self) -> Optional[list]:
        self._check_open()
        if self._pos >= len(self._rows):
            return None
        row = self._rows[self._pos]
        self._pos += 1
        return row

    def fetchmany(self, size: Optional[int] = None) -> list[list]:
        self._check_open()
        n = size if size is not None else self.arraysize
        out = self._rows[self._pos:self._pos + n]
        self._pos += len(out)
        return out

    def fetchall(self) -> list[list]:
        self._check_open()
        out = self._rows[self._pos:]
        self._pos = len(self._rows)
        return out

    def __iter__(self) -> Iterator[list]:
        while True:
            row = self.fetchone()
            if row is None:
                return
            yield row

    # -- no-ops mandated by the spec ---------------------------------------
    def setinputsizes(self, sizes):
        pass

    def setoutputsize(self, size, column=None):
        pass

    def close(self) -> None:
        self._rows = []
        self._conn = None

    def _check_open(self) -> None:
        if self._conn is None or self._conn._closed:
            raise InterfaceError("cursor is closed")


class Connection:
    def __init__(self, broker_url: str, timeout_s: float = 60.0,
                 auth=None, token: Optional[str] = None):
        self._http = _HttpConnection(broker_url, timeout_s, auth=auth,
                                     token=token)
        self._closed = False

    def cursor(self) -> Cursor:
        if self._closed:
            raise InterfaceError("connection is closed")
        return Cursor(self)

    def close(self) -> None:
        self._closed = True

    def commit(self) -> None:
        pass  # queries are read-only; commit is a spec-mandated no-op

    def rollback(self) -> None:
        raise NotSupportedError("transactions are not supported")

    def __enter__(self) -> "Connection":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def connect(broker_url: str, timeout_s: float = 60.0, auth=None,
            token: Optional[str] = None) -> Connection:
    return Connection(broker_url, timeout_s, auth=auth, token=token)
