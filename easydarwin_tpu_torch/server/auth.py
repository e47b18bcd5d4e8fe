"""RTSP authentication: Basic and Digest, a users file, per-path rules.

A qtpasswd-style users file holds ``user:realm:MD5(user:realm:password)``
lines; qtaccess-style rules map a path prefix to who may play or push it
(``require user a b``, ``require valid-user``, or open).  Digest follows
RFC 2617 MD5 with server nonces that expire after ``NONCE_TTL`` seconds;
Basic decodes and hashes through the same table.  The RTSP layer asks
``authorize`` before DESCRIBE, SETUP, ANNOUNCE, PLAY and RECORD and
answers 401 with ``challenge()`` when it refuses.
"""

from __future__ import annotations

import base64
import hashlib
import os
import secrets
import time


def ha1(user: str, realm: str, password: str) -> str:
    return hashlib.md5(f"{user}:{realm}:{password}".encode()).hexdigest()


class UsersFile:
    """``user:realm:ha1`` lines (what qtpasswd writes)."""

    def __init__(self, path: str | None = None, realm: str = "easydarwin-tpu"):
        self.path = path
        self.realm = realm
        self.users: dict[str, str] = {}        # user -> ha1
        if path and os.path.exists(path):
            self.load()

    def load(self) -> None:
        self.users.clear()
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(":")
                if len(parts) == 3:
                    user, realm, digest = parts
                    self.users[user] = digest
                    self.realm = realm

    def add(self, user: str, password: str) -> None:
        self.users[user] = ha1(user, self.realm, password)

    def check_password(self, user: str, password: str) -> bool:
        want = self.users.get(user)
        return want is not None and want == ha1(user, self.realm, password)


class AccessRules:
    """Longest-prefix path rules: None = open, [] = any valid user,
    [names] = the listed users only."""

    def __init__(self):
        self._rules: dict[str, list[str] | None] = {}

    def protect(self, prefix: str, users: list[str] | None = None) -> None:
        self._rules[prefix.rstrip("/") or "/"] = (
            list(users) if users is not None else [])

    def open_path(self, prefix: str) -> None:
        self._rules[prefix.rstrip("/") or "/"] = None

    def required_users(self, path: str) -> list[str] | None:
        best, rule = -1, None
        for prefix, users in self._rules.items():
            if (path == prefix or path.startswith(prefix + "/")
                    or prefix == "/"):
                if len(prefix) > best:
                    best, rule = len(prefix), users
        return rule


class AuthService:
    NONCE_TTL = 300.0

    def __init__(self, users: UsersFile, rules: AccessRules | None = None,
                 *, scheme: str = "digest"):
        self.users = users
        self.rules = rules or AccessRules()
        self.scheme = scheme
        self._nonces: dict[str, float] = {}

    # -- challenge ---------------------------------------------------------
    def challenge(self) -> str:
        if self.scheme == "basic":
            return f'Basic realm="{self.users.realm}"'
        nonce = secrets.token_hex(16)
        self._nonces[nonce] = time.time()
        return (f'Digest realm="{self.users.realm}", nonce="{nonce}", '
                f'algorithm=MD5')

    def _nonce_ok(self, nonce: str) -> bool:
        t = self._nonces.get(nonce)
        if t is None or time.time() - t > self.NONCE_TTL:
            self._nonces.pop(nonce, None)
            return False
        return True

    # -- verification ------------------------------------------------------
    def authorize(self, path: str, method: str,
                  authorization: str | None) -> tuple[bool, str | None]:
        """(allowed, authenticated user). Paths with no rule are open."""
        required = self.rules.required_users(path)
        if required is None:
            return True, None
        user = self._authenticate(method, authorization)
        if user is None or (required and user not in required):
            return False, user
        return True, user

    def _authenticate(self, method: str, header: str | None) -> str | None:
        if not header:
            return None
        scheme, _, rest = header.partition(" ")
        scheme = scheme.lower()
        if scheme == "basic":
            try:
                user, _, pw = base64.b64decode(rest).decode().partition(":")
            except (ValueError, UnicodeDecodeError):
                return None
            return user if self.users.check_password(user, pw) else None
        if scheme == "digest":
            fields = {}
            for part in rest.split(","):
                k, _, v = part.strip().partition("=")
                fields[k.lower()] = v.strip('"')
            user = fields.get("username", "")
            nonce = fields.get("nonce", "")
            uri = fields.get("uri", "")
            resp = fields.get("response", "")
            if not self._nonce_ok(nonce):
                return None
            h1 = self.users.users.get(user)
            if h1 is None:
                return None
            h2 = hashlib.md5(f"{method}:{uri}".encode()).hexdigest()
            want = hashlib.md5(f"{h1}:{nonce}:{h2}".encode()).hexdigest()
            return user if secrets.compare_digest(want, resp) else None
        return None


def digest_response(user: str, password: str, realm: str, method: str,
                    uri: str, nonce: str) -> str:
    """The client's ``Authorization`` header for a Digest challenge;
    ``uri`` is the request's URI as sent, not its path."""
    h1 = ha1(user, realm, password)
    h2 = hashlib.md5(f"{method}:{uri}".encode()).hexdigest()
    resp = hashlib.md5(f"{h1}:{nonce}:{h2}".encode()).hexdigest()
    return (f'Digest username="{user}", realm="{realm}", nonce="{nonce}", '
            f'uri="{uri}", response="{resp}"')


def auth_from_config(cfg) -> AuthService | None:
    """The RTSP auth a config asks for (None: ``rtsp_auth_enabled`` off):
    the users file, and any valid user on every path, as the reference."""
    if not cfg.rtsp_auth_enabled:
        return None
    rules = AccessRules()
    rules.protect("/", [])
    return AuthService(UsersFile(cfg.users_file or None), rules,
                       scheme=cfg.auth_scheme)
