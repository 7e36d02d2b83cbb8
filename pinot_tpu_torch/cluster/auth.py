"""Access control: authentication + table-level authorization.

The port's copy of pinot_tpu/cluster/auth.py, used by cluster/rest.py.

Reference: pinot-controller/.../api/access/AccessControl.java (+
BasicAuthAccessControlFactory in pinot-core, ZkBasicAuthAccessControl) —
every REST request resolves a principal from its Authorization header, and
each endpoint checks (principal, table, access type). Providers are
pluggable; AllowAll is the default, Basic auth (user:password) and Bearer
tokens ship in-tree.

Principals carry table patterns ("*" or explicit names) and permission
sets (READ/WRITE) exactly like the reference's BasicAuthPrincipal.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
from dataclasses import dataclass
from typing import Mapping, Optional

from .controller import raw_table_name

READ = "READ"
WRITE = "WRITE"


@dataclass
class Principal:
    name: str
    tables: tuple = ("*",)  # "*" or explicit raw table names
    permissions: frozenset = frozenset({READ, WRITE})

    def allows(self, table: Optional[str], access_type: str) -> bool:
        if access_type not in self.permissions:
            return False
        if table is None or "*" in self.tables:
            return True
        return raw_table_name(table) in self.tables


class AccessControl:
    """Provider interface (reference AccessControl.java)."""

    def authenticate(self, headers: Mapping[str, str]) -> Optional[Principal]:
        """Header map → principal, or None when unauthenticated."""
        raise NotImplementedError

    def has_access(self, principal: Optional[Principal],
                   table: Optional[str], access_type: str) -> bool:
        raise NotImplementedError


class AllowAllAccessControl(AccessControl):
    """Default: everything allowed (reference AllowAllAccessFactory)."""

    def authenticate(self, headers) -> Principal:
        return Principal("anonymous")

    def has_access(self, principal, table, access_type) -> bool:
        return True


def _hash(secret: str) -> str:
    return hashlib.sha256(secret.encode("utf-8")).hexdigest()


@dataclass
class _Entry:
    principal: Principal
    secret_hash: str


class BasicAuthAccessControl(AccessControl):
    """``Authorization: Basic base64(user:password)`` or
    ``Authorization: Bearer <token>`` (reference
    BasicAuthAccessControlFactory; tokens are the user-less variant).

    principals: list of dicts
        {"username": ..., "password": ...} or {"token": ...}
        plus optional "tables": ["*"] | [names], "permissions": ["READ",...]
    Secrets are stored hashed; comparison is constant-time.
    """

    def __init__(self, principals: list[dict]):
        self._by_user: dict[str, _Entry] = {}
        self._tokens: dict[str, Principal] = {}
        for p in principals:
            tables = tuple(p.get("tables", ["*"]))
            perms = frozenset(p.get("permissions", [READ, WRITE]))
            if "token" in p:
                name = p.get("username", f"token:{p['token'][:6]}")
                self._tokens[_hash(p["token"])] = Principal(name, tables, perms)
            else:
                prin = Principal(p["username"], tables, perms)
                self._by_user[p["username"]] = _Entry(prin, _hash(p["password"]))

    def authenticate(self, headers) -> Optional[Principal]:
        auth = None
        for k, v in headers.items():
            if k.lower() == "authorization":
                auth = v
                break
        if not auth:
            return None
        scheme, _, value = auth.partition(" ")
        scheme = scheme.lower()
        if scheme == "basic":
            try:
                user, _, password = base64.b64decode(value.strip()) \
                    .decode("utf-8").partition(":")
            except Exception:
                return None
            entry = self._by_user.get(user)
            if entry is None:
                return None
            if hmac.compare_digest(entry.secret_hash, _hash(password)):
                return entry.principal
            return None
        if scheme == "bearer":
            # dict lookup by sha256 of the presented token: equivalent to a
            # constant-time scan for fixed-length high-entropy digests
            return self._tokens.get(_hash(value.strip()))
        return None

    def has_access(self, principal, table, access_type) -> bool:
        return principal is not None and principal.allows(table, access_type)
