"""v2 auth — basic-auth users/roles guarding the /v2/keys surface
(etcd_tpu/server/v2auth.py).

Re-design of ``server/etcdserver/api/v2auth/auth.go`` + the guard logic
of ``api/v2http/client_auth.go``: users (password hash + role list) and
roles (key-pattern read/write permission lists with trailing-``*``
globs, auth.go:574-614 simpleMatch/prefixMatch) live in the replicated
v2 tree itself under a hidden ``/_security`` subtree — every mutation
is a committed v2 request, so all members agree on who may do what.
``root`` user + implicit root role gate admin operations; the ``guest``
role (auto-created full-access on enable, auth.go:368-398) covers
unauthenticated requests.
"""
from __future__ import annotations

import hashlib
import json

from etcd_tpu_torch.server.v2store import EcodeKeyNotFound, V2Error

PREFIX = "/_security"  # StorePermsPrefix analog (hidden subtree)
GUEST_ROLE = "guest"
ROOT_ROLE = "root"

GUEST_PERMISSIONS = {"kv": {"read": ["/*"], "write": ["/*"]}}


class AuthError(Exception):
    """v2auth.Error: message + HTTP status."""

    def __init__(self, status: int, msg: str):
        self.status = status
        super().__init__(f"auth: {msg}")


def hash_password(password: str) -> str:
    # passwordStore.HashPassword (bcrypt in the reference; a keyed
    # sha256 here — the contract is deterministic verify, not KDF parity)
    return hashlib.sha256(b"etcd-tpu-v2auth:" +
                          password.encode()).hexdigest()


def simple_match(pattern: str, key: str) -> bool:
    if pattern.endswith("*"):
        return key.startswith(pattern[:-1])
    return key == pattern


def prefix_match(pattern: str, key: str) -> bool:
    if not pattern.endswith("*"):
        return False
    return key.startswith(pattern[:-1])


def has_access(perms: dict, key: str, write: bool,
               recursive: bool = False) -> bool:
    """RWPermission.HasAccess / HasRecursiveAccess (auth.go:574-602)."""
    pats = perms.get("kv", {}).get("write" if write else "read", [])
    match = prefix_match if recursive else simple_match
    return any(match(p, key) for p in pats)


class V2AuthStore:
    """auth.go store: CRUD over replicated /_security records."""

    def __init__(self, ec):
        self.ec = ec

    # ---- raw record access (auth_requests.go path scheme)
    def _get(self, path: str) -> dict | None:
        try:
            e = self.ec.v2_get(PREFIX + path)
        except V2Error as err:
            if err.code == EcodeKeyNotFound:
                return None
            raise
        return json.loads(e.node["value"])

    def _put(self, path: str, value: dict) -> None:
        self.ec.v2_request("PUT", PREFIX + path, val=json.dumps(value))

    def _delete(self, path: str) -> None:
        self.ec.v2_request("DELETE", PREFIX + path)

    def _list(self, path: str) -> list[str]:
        try:
            e = self.ec.v2_get(PREFIX + path)
        except V2Error as err:
            if err.code == EcodeKeyNotFound:
                return []
            raise
        return sorted(n["key"].rsplit("/", 1)[-1]
                      for n in e.node.get("nodes", []))

    # ---- users
    def create_user(self, name: str, password: str,
                    roles: list[str] | None = None) -> dict:
        if self._get(f"/users/{name}") is not None:
            raise AuthError(409, f"user {name} already exists")
        u = {"user": name, "password": hash_password(password),
             "roles": sorted(roles or [])}
        self._put(f"/users/{name}", u)
        return {"user": name, "roles": u["roles"]}

    def get_user(self, name: str) -> dict:
        u = self._get(f"/users/{name}")
        if u is None:
            raise AuthError(404, f"user {name} does not exist")
        return u

    def all_users(self) -> list[str]:
        return self._list("/users")

    def delete_user(self, name: str) -> None:
        if self.auth_enabled() and name == "root":
            raise AuthError(403, "cannot delete root user while "
                            "auth is enabled")
        self.get_user(name)
        self._delete(f"/users/{name}")

    def update_user(self, name: str, password: str | None = None,
                    grant: list[str] | None = None,
                    revoke: list[str] | None = None) -> dict:
        # User.merge (auth.go:418-461)
        u = self.get_user(name)
        if password is not None:
            u["password"] = hash_password(password)
        roles = set(u.get("roles", []))
        for r in grant or []:
            if r in roles:
                raise AuthError(409,
                                f"duplicate role {r} for user {name}")
            roles.add(r)
        for r in revoke or []:
            if r not in roles:
                raise AuthError(409,
                                f"revoking ungranted role {r} from "
                                f"user {name}")
            roles.discard(r)
        u["roles"] = sorted(roles)
        self._put(f"/users/{name}", u)
        return {"user": name, "roles": u["roles"]}

    # ---- roles
    def create_role(self, name: str,
                    permissions: dict | None = None) -> dict:
        if name == ROOT_ROLE:
            raise AuthError(403, f"invalid role name {name}")
        if self._get(f"/roles/{name}") is not None:
            raise AuthError(409, f"role {name} already exists")
        r = {"role": name,
             "permissions": permissions or {"kv": {"read": [],
                                                   "write": []}}}
        self._put(f"/roles/{name}", r)
        return r

    def get_role(self, name: str) -> dict:
        if name == ROOT_ROLE:
            # the implicit root role: full access everywhere
            return {"role": ROOT_ROLE,
                    "permissions": {"kv": {"read": ["/*"],
                                           "write": ["/*"]}}}
        r = self._get(f"/roles/{name}")
        if r is None:
            raise AuthError(404, f"role {name} does not exist")
        return r

    def all_roles(self) -> list[str]:
        return sorted(self._list("/roles") + [ROOT_ROLE])

    def delete_role(self, name: str) -> None:
        self.get_role(name)
        self._delete(f"/roles/{name}")

    def update_role(self, name: str, grant: dict | None = None,
                    revoke: dict | None = None) -> dict:
        # Role.merge / Permissions.Grant/Revoke (auth.go:463-572)
        r = self.get_role(name)
        perms = r["permissions"]["kv"]
        for mode in ("read", "write"):
            for pat in (grant or {}).get("kv", {}).get(mode, []):
                if pat in perms[mode]:
                    raise AuthError(409, f"duplicate permission {pat}")
                perms[mode].append(pat)
            for pat in (revoke or {}).get("kv", {}).get(mode, []):
                if pat not in perms[mode]:
                    raise AuthError(409,
                                    f"revoking ungranted permission "
                                    f"{pat}")
                perms[mode].remove(pat)
            perms[mode].sort()
        self._put(f"/roles/{name}", r)
        return r

    # ---- enable/disable (auth.go:364-416)
    def auth_enabled(self) -> bool:
        return bool(self._get("/enabled"))

    def enable_auth(self) -> None:
        if self.auth_enabled():
            raise AuthError(409, "already enabled")
        if self._get("/users/root") is None:
            raise AuthError(409, "No root user available, please "
                            "create one")
        if self._get(f"/roles/{GUEST_ROLE}") is None:
            self.create_role(GUEST_ROLE, dict(GUEST_PERMISSIONS))
        self._put("/enabled", True)

    def disable_auth(self) -> None:
        if not self.auth_enabled():
            raise AuthError(409, "already disabled")
        self._put("/enabled", False)

    # ---- the guard (client_auth.go userFromBasicAuth +
    # hasKeyPrefixAccess)
    def check_password(self, name: str, password: str) -> dict:
        u = self._get(f"/users/{name}")
        if u is None or u["password"] != hash_password(password):
            raise AuthError(401, "incorrect password")
        return u

    def is_root(self, creds: tuple[str, str] | None) -> bool:
        if not self.auth_enabled():
            return True  # no auth: everyone is admin
        if creds is None:
            return False
        try:
            u = self.check_password(*creds)
        except AuthError:
            return False
        return ROOT_ROLE in u.get("roles", []) or u["user"] == "root"

    def check_key_access(self, creds: tuple[str, str] | None, key: str,
                         write: bool, recursive: bool = False) -> None:
        """Raise AuthError unless creds may touch `key`."""
        if not self.auth_enabled():
            return
        if key.startswith(PREFIX):
            raise AuthError(403, "the security subtree is internal")
        if creds is None:
            roles = [GUEST_ROLE]
        else:
            u = self.check_password(*creds)
            if ROOT_ROLE in u.get("roles", []) or u["user"] == "root":
                return
            roles = u.get("roles", [])
        for rname in roles:
            try:
                r = self.get_role(rname)
            except AuthError:
                continue
            if has_access(r["permissions"], key, write, recursive):
                return
        who = creds[0] if creds else "guest"
        raise AuthError(401 if creds else 403,
                        f"no {'write' if write else 'read'} access to "
                        f"{key} for {who}")
