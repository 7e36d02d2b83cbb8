"""Python client: connect to a broker over HTTP and run SQL (the port of
pinot_tpu/client.py).

Reference analogue: pinot-clients/pinot-java-client (Connection.execute →
broker /query/sql) and the JDBC driver's ResultSet surface. Zero-dependency
urllib; `connect()` is the module entry like the reference's
ConnectionFactory.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Iterator, Optional


class PinotClientError(Exception):
    pass


class ResultSet:
    """Row/column access over one query's result table."""

    def __init__(self, response: dict):
        self._response = response
        table = response.get("resultTable") or {}
        schema = table.get("dataSchema") or {}
        self.column_names: list[str] = schema.get("columnNames", [])
        self.column_types: list[str] = schema.get("columnDataTypes", [])
        self.rows: list[list] = table.get("rows", [])

    def __len__(self) -> int:
        return len(self.rows)

    def __iter__(self) -> Iterator[list]:
        return iter(self.rows)

    def get(self, row: int, column) -> object:
        if isinstance(column, str):
            column = self.column_names.index(column)
        return self.rows[row][column]

    @property
    def execution_stats(self) -> dict:
        return {k: v for k, v in self._response.items() if k != "resultTable"}


class Connection:
    def __init__(self, broker_url: str, timeout_s: float = 60.0,
                 auth=None, token: str = None):
        """``auth=(user, password)`` sends Basic auth; ``token`` sends a
        Bearer token (cluster/auth.py providers)."""
        self.broker_url = broker_url.rstrip("/")
        self.timeout_s = timeout_s
        self._auth_header = None
        if auth is not None:
            import base64

            cred = base64.b64encode(f"{auth[0]}:{auth[1]}".encode()).decode()
            self._auth_header = f"Basic {cred}"
        elif token is not None:
            self._auth_header = f"Bearer {token}"

    def execute(self, sql: str) -> ResultSet:
        resp = self._post("/query/sql", {"sql": sql})
        if resp.get("exceptions"):
            raise PinotClientError(str(resp["exceptions"]))
        return ResultSet(resp)

    def execute_timeseries(self, query: str, start: int, end: int, step: int,
                           language: str = "m3ql") -> dict:
        return self._post("/timeseries/api/v1/query_range", {
            "query": query, "start": start, "end": end, "step": step,
            "language": language})

    def _post(self, path: str, body: dict) -> dict:
        headers = {"Content-Type": "application/json"}
        if self._auth_header:
            headers["Authorization"] = self._auth_header
        req = urllib.request.Request(
            self.broker_url + path,
            data=json.dumps(body).encode("utf-8"), headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return json.loads(r.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            if e.code in (401, 403):
                raise PinotClientError(
                    f"HTTP {e.code}: access denied for {path}") from e
            try:
                return json.loads(e.read().decode("utf-8"))
            except ValueError:
                raise PinotClientError(f"HTTP {e.code} from {path}") from e
        except OSError as e:
            raise PinotClientError(f"cannot reach broker: {e}") from e


def connect(broker_url: str, timeout_s: float = 60.0, auth=None,
            token: str = None) -> Connection:
    """Reference: ConnectionFactory.fromHostList."""
    return Connection(broker_url, timeout_s, auth=auth, token=token)
