"""Auth store — users, RBAC roles with key-interval permissions, tokens.

Mirrors ``server/auth/store.go``: bcrypt'd users (scrypt here — stdlib;
bcrypt is an external dep in the reference, auth/store.go:90 iface area),
roles grant {READ, WRITE, READWRITE} over key ranges (interval perms cached
per user, auth/range_perm_cache.go), and every mutation bumps an
*auth revision* so tokens minted under an older ACL are rejected
(store.go's authRevision / ErrAuthOldRevision). Two token providers, as in
the reference (auth/store.go NewTokenProvider): `simple` — opaque TTL'd
random tokens held in node-local memory — and `jwt` — stateless signed
tokens carrying {username, revision, exp} claims (auth/jwt.go:28,117)
with the reference's full sign-method set (options.go:88-103):
HS256/384/512 shared-secret HMAC plus RS*/PS*/ES* PEM keypairs, and
verify-only operation when only a public key is configured.

The port's copy of etcd_tpu/server/auth.py, which it imports nothing of.
"""
from __future__ import annotations

import base64
import dataclasses
import hashlib
import hmac
import json
import os
import secrets


class AuthError(Exception):
    pass


class ErrAuthNotEnabled(AuthError):
    pass


class ErrUserNotFound(AuthError):
    pass


class ErrUserAlreadyExist(AuthError):
    pass


class ErrRoleNotFound(AuthError):
    pass


class ErrRoleAlreadyExist(AuthError):
    pass


class ErrAuthFailed(AuthError):
    pass


class ErrPermissionDenied(AuthError):
    pass


class ErrInvalidAuthToken(AuthError):
    pass


class ErrAuthOldRevision(AuthError):
    pass


READ, WRITE, READWRITE = 0, 1, 2


def _b64url(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).rstrip(b"=").decode()


def _b64url_dec(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


_JWT_HASHES = {"256": hashlib.sha256, "384": hashlib.sha384,
               "512": hashlib.sha512}
# ES* fixed-width (r||s) coordinate sizes per curve (RFC 7518 §3.4)
_EC_COORD_BYTES = {"secp256r1": 32, "secp384r1": 48, "secp521r1": 66}
_ES_CURVE = {"ES256": "secp256r1", "ES384": "secp384r1",
             "ES512": "secp521r1"}


class JWTTokenProvider:
    """Stateless JWT provider (auth/jwt.go:28 tokenJWT).

    Sign methods mirror the reference's (auth/options.go:88-103 +
    jwt.go:152-156): HS256/384/512 (HMAC shared secret), RS*/PS* (RSA /
    RSA-PSS PEM keypair), ES* (ECDSA PEM keypair on the matching
    curve). A PUBLIC key yields a verify-only provider — it can check
    tokens minted elsewhere but not assign (jwt.go:150-160 verifyOnly).

    assign() mints {username, revision, exp} claims (jwt.go:117-127);
    info() verifies the signature + algorithm and rejects expired tokens.
    Like the reference, user deletion does NOT invalidate outstanding jwt
    tokens (tokenJWT.invalidateUser is a no-op, jwt.go:38) — revocation
    happens through the auth-revision check at permission time.
    """

    def __init__(self, key: bytes, ttl: int = 300, sign_method: str = "HS256"):
        family, bits = sign_method[:2], sign_method[2:]
        if family not in ("HS", "RS", "PS", "ES") or \
                bits not in _JWT_HASHES:
            raise AuthError(f"unsupported jwt sign method {sign_method!r}")
        if not key:
            raise AuthError("jwt token provider requires a signing key")
        self.ttl = ttl
        self.sign_method = sign_method
        self._family = family
        self._hash = _JWT_HASHES[bits]
        self.verify_only = False
        if family == "HS":
            self.key = key
            self._priv = self._pub = None
        else:
            self.key = None
            self._priv, self._pub = self._load_asym_key(key)

    def _load_asym_key(self, pem: bytes):
        """PEM private key → (priv, pub); PEM public key → (None, pub)
        for verify-only providers. Key type must match the method."""
        try:
            from cryptography.hazmat.primitives import serialization
            from cryptography.hazmat.primitives.asymmetric import ec, rsa
        except ImportError:
            raise AuthError(
                f"jwt {self.sign_method} needs the 'cryptography' "
                "package; only HS* methods work without it") from None

        priv = pub = None
        try:
            priv = serialization.load_pem_private_key(pem, password=None)
            pub = priv.public_key()
        except TypeError:
            raise AuthError(
                f"jwt {self.sign_method}: password-protected private "
                "keys are not supported") from None
        except ValueError:
            try:
                pub = serialization.load_pem_public_key(pem)
            except (ValueError, TypeError):
                raise AuthError(
                    f"jwt {self.sign_method}: key is neither a PEM "
                    "private nor public key") from None
            self.verify_only = True
        except Exception as e:  # UnsupportedAlgorithm and kin
            raise AuthError(
                f"jwt {self.sign_method}: cannot load key: {e}") from None
        want = rsa.RSAPublicKey if self._family in ("RS", "PS") \
            else ec.EllipticCurvePublicKey
        if not isinstance(pub, want):
            raise AuthError(
                f"jwt {self.sign_method} requires an "
                f"{'RSA' if self._family != 'ES' else 'ECDSA'} key")
        if self._family == "ES":
            want_curve = _ES_CURVE[self.sign_method]
            if pub.curve.name != want_curve:
                raise AuthError(
                    f"jwt {self.sign_method} requires curve "
                    f"{want_curve}, got {pub.curve.name}")
        return priv, pub

    def _crypto_hash(self):
        from cryptography.hazmat.primitives import hashes

        return {hashlib.sha256: hashes.SHA256, hashlib.sha384:
                hashes.SHA384, hashlib.sha512: hashes.SHA512}[
                    self._hash]()

    def _rsa_padding(self, for_verify: bool = False):
        from cryptography.hazmat.primitives.asymmetric import padding

        if self._family == "PS":
            h = self._crypto_hash()
            # sign with salt = digest size (RFC 7518); verify with AUTO
            # so tokens from signers using max-length salt (golang-jwt,
            # hence reference-built etcds) also pass
            salt = padding.PSS.AUTO if for_verify else h.digest_size
            return padding.PSS(mgf=padding.MGF1(h), salt_length=salt)
        return padding.PKCS1v15()

    def _sign(self, signing_input: bytes) -> bytes:
        if self._family == "HS":
            return hmac.new(self.key, signing_input, self._hash).digest()
        if self.verify_only or self._priv is None:
            raise ErrInvalidAuthToken(
                "verify-only jwt provider cannot assign tokens")
        if self._family in ("RS", "PS"):
            return self._priv.sign(signing_input, self._rsa_padding(),
                                   self._crypto_hash())
        # ES*: DER → fixed-width r||s (RFC 7518 §3.4)
        from cryptography.hazmat.primitives.asymmetric import ec, utils

        der = self._priv.sign(signing_input,
                              ec.ECDSA(self._crypto_hash()))
        r, s = utils.decode_dss_signature(der)
        n = _EC_COORD_BYTES[self._priv.curve.name]
        return r.to_bytes(n, "big") + s.to_bytes(n, "big")

    def _verify(self, signing_input: bytes, sig: bytes) -> bool:
        if self._family == "HS":
            return hmac.compare_digest(self._sign(signing_input), sig)
        from cryptography.exceptions import InvalidSignature

        try:
            if self._family in ("RS", "PS"):
                self._pub.verify(sig, signing_input,
                                 self._rsa_padding(for_verify=True),
                                 self._crypto_hash())
                return True
            from cryptography.hazmat.primitives.asymmetric import (
                ec,
                utils,
            )

            n = _EC_COORD_BYTES[self._pub.curve.name]
            if len(sig) != 2 * n:
                return False
            der = utils.encode_dss_signature(
                int.from_bytes(sig[:n], "big"),
                int.from_bytes(sig[n:], "big"))
            self._pub.verify(der, signing_input,
                             ec.ECDSA(self._crypto_hash()))
            return True
        except InvalidSignature:
            return False

    def assign(self, username: str, revision: int, now: int) -> str:
        header = _b64url(json.dumps(
            {"alg": self.sign_method, "typ": "JWT"},
            separators=(",", ":"), sort_keys=True).encode())
        claims = _b64url(json.dumps(
            {"username": username, "revision": revision,
             "exp": now + self.ttl},
            separators=(",", ":"), sort_keys=True).encode())
        signing_input = f"{header}.{claims}".encode()
        return f"{header}.{claims}.{_b64url(self._sign(signing_input))}"

    def info(self, token: str, now: int) -> tuple[str, int]:
        try:
            header_s, claims_s, sig_s = token.split(".")
            header = json.loads(_b64url_dec(header_s))
            if header.get("alg") != self.sign_method:
                raise ErrInvalidAuthToken("invalid signing method")
            if not self._verify(f"{header_s}.{claims_s}".encode(),
                                _b64url_dec(sig_s)):
                raise ErrInvalidAuthToken("bad signature")
            claims = json.loads(_b64url_dec(claims_s))
            username = claims["username"]
            revision = int(claims["revision"])
            exp = int(claims["exp"])
        except ErrInvalidAuthToken:
            raise
        except Exception:
            raise ErrInvalidAuthToken("malformed jwt token")
        if exp <= now:
            raise ErrInvalidAuthToken("expired jwt token")
        return username, revision


@dataclasses.dataclass
class Permission:
    perm_type: int
    key: bytes
    range_end: bytes | None = None

    # coverage checks live on the unified per-user interval trees
    # (AuthStore._perm_cache), not per-permission — the reference's
    # range_perm_cache merges abutting grants before checking


@dataclasses.dataclass
class User:
    name: str
    salt: bytes
    pw_hash: bytes
    roles: set[str] = dataclasses.field(default_factory=set)
    no_password: bool = False


@dataclasses.dataclass
class Role:
    name: str
    perms: list[Permission] = dataclasses.field(default_factory=list)


def _hash(password: str, salt: bytes) -> bytes:
    return hashlib.scrypt(password.encode(), salt=salt, n=2**10, r=8, p=1)


class AuthStore:
    ROOT_USER = "root"
    ROOT_ROLE = "root"
    TOKEN_TTL = 300  # simpleTokenTTL (auth/simple_token.go), in ticks here

    def __init__(self, token: str = "simple", jwt_key: bytes | None = None):
        """`token` mirrors the reference's --auth-token flag
        (auth/store.go NewTokenProvider): "simple", or
        "jwt[,sign-method=HS256][,ttl=SECONDS]" with the signing key
        supplied via `jwt_key` (the priv-key= file of the reference)."""
        self.enabled = False
        self.revision = 1
        self.users: dict[str, User] = {}
        self.roles: dict[str, Role] = {}
        # (user, write?) -> (auth_revision, unified interval tree) — the
        # rangePermCache analog, invalidated by revision movement
        self._perm_trees: dict = {}
        # token -> (username, auth_revision, expiry_tick)  [simple provider]
        self.tokens: dict[str, tuple[str, int, int]] = {}
        self.now = 0
        parts = token.split(",")
        self.token_type = parts[0]
        if self.token_type == "jwt":
            try:
                opts = dict(p.split("=", 1) for p in parts[1:] if p)
                ttl = int(opts.get("ttl", self.TOKEN_TTL))
            except ValueError as e:
                raise AuthError(f"invalid jwt token options {token!r}: {e}")
            self.jwt = JWTTokenProvider(
                key=jwt_key or b"",
                ttl=ttl,
                sign_method=opts.get("sign-method", "HS256"),
            )
        elif self.token_type == "simple":
            self.jwt = None
        else:
            raise AuthError(f"unknown token provider {self.token_type!r}")

    def tick(self, n: int = 1) -> None:
        self.now += n
        for t in [t for t, (_, _, exp) in self.tokens.items() if exp <= self.now]:
            del self.tokens[t]

    def _bump(self) -> None:
        self.revision += 1

    # -- enable/disable (store.go AuthEnable/AuthDisable) --------------------
    def auth_enable(self) -> None:
        root = self.users.get(self.ROOT_USER)
        if root is None:
            raise ErrUserNotFound("root user does not exist")
        if self.ROOT_ROLE not in root.roles:
            raise AuthError("root user does not have root role")
        self.enabled = True
        self._bump()

    def auth_disable(self) -> None:
        self.enabled = False
        self.tokens.clear()
        self._bump()

    # -- users ---------------------------------------------------------------
    def user_add(self, name: str, password: str = "", no_password: bool = False,
                 salt: bytes | None = None, pw_hash: bytes | None = None):
        """Apply-path user creation. For replicated applies the proposer
        hashes the password once and ships (salt, pw_hash) inside the entry
        — matching auth/store.go, which stores the bcrypt hash carried by
        the AuthUserAdd request — so every member (and every deterministic
        replay) produces identical auth state."""
        if name in self.users:
            raise ErrUserAlreadyExist(name)
        if salt is None:
            salt = os.urandom(16)
        if pw_hash is None:
            pw_hash = b"" if no_password else _hash(password, salt)
        self.users[name] = User(
            name, salt, b"" if no_password else pw_hash,
            no_password=no_password,
        )
        self._bump()

    def user_delete(self, name: str):
        if name == self.ROOT_USER and self.enabled:
            raise AuthError("cannot delete root user while auth is enabled")
        if name not in self.users:
            raise ErrUserNotFound(name)
        del self.users[name]
        self.tokens = {
            t: v for t, v in self.tokens.items() if v[0] != name
        }
        self._bump()

    def user_change_password(self, name: str, password: str = "",
                             salt: bytes | None = None,
                             pw_hash: bytes | None = None):
        """See user_add: (salt, pw_hash) are precomputed by the proposer for
        deterministic replicated applies."""
        u = self.users.get(name)
        if u is None:
            raise ErrUserNotFound(name)
        u.salt = salt if salt is not None else os.urandom(16)
        u.pw_hash = pw_hash if pw_hash is not None else _hash(password, u.salt)
        self._bump()

    def user_grant_role(self, name: str, role: str):
        u = self.users.get(name)
        if u is None:
            raise ErrUserNotFound(name)
        if role != self.ROOT_ROLE and role not in self.roles:
            raise ErrRoleNotFound(role)
        u.roles.add(role)
        self._bump()

    def user_revoke_role(self, name: str, role: str):
        u = self.users.get(name)
        if u is None:
            raise ErrUserNotFound(name)
        u.roles.discard(role)
        self._bump()

    # -- roles ---------------------------------------------------------------
    def role_add(self, name: str):
        if name in self.roles:
            raise ErrRoleAlreadyExist(name)
        self.roles[name] = Role(name)
        self._bump()

    def role_delete(self, name: str):
        if name == self.ROOT_ROLE:
            raise AuthError("cannot delete root role")
        if name not in self.roles:
            raise ErrRoleNotFound(name)
        del self.roles[name]
        for u in self.users.values():
            u.roles.discard(name)
        self._bump()

    def role_grant_permission(self, role: str, perm: Permission):
        r = self.roles.get(role)
        if r is None:
            raise ErrRoleNotFound(role)
        r.perms = [
            p for p in r.perms
            if (p.key, p.range_end) != (perm.key, perm.range_end)
        ] + [perm]
        self._bump()

    def role_revoke_permission(self, role: str, key: bytes, range_end=None):
        r = self.roles.get(role)
        if r is None:
            raise ErrRoleNotFound(role)
        r.perms = [
            p for p in r.perms if (p.key, p.range_end) != (key, range_end)
        ]
        self._bump()

    # -- snapshot/restore (the authBuckets content in schema/auth.go) --------
    def to_snapshot(self) -> dict:
        """Replicated auth state only — tokens are node-local and ephemeral
        (the reference's simple tokens live in memory, not the backend)."""
        return {
            "enabled": self.enabled,
            "revision": self.revision,
            "users": {
                n: {
                    "salt": u.salt,
                    "pw_hash": u.pw_hash,
                    "roles": sorted(u.roles),
                    "no_password": u.no_password,
                }
                for n, u in self.users.items()
            },
            "roles": {
                n: [
                    (p.perm_type, p.key, p.range_end) for p in r.perms
                ]
                for n, r in self.roles.items()
            },
        }

    def restore(self, snap: dict) -> None:
        self.enabled = snap["enabled"]
        self.revision = snap["revision"]
        self.users = {
            n: User(n, d["salt"], d["pw_hash"], set(d["roles"]),
                    d["no_password"])
            for n, d in snap["users"].items()
        }
        self.roles = {
            n: Role(n, [Permission(t, k, re) for t, k, re in perms])
            for n, perms in snap["roles"].items()
        }
        self.tokens.clear()
        self._perm_trees.clear()

    # -- authn (simple token provider) ---------------------------------------
    def authenticate(self, name: str, password: str) -> str:
        if not self.enabled:
            raise ErrAuthNotEnabled()
        u = self.users.get(name)
        if u is None:
            raise ErrAuthFailed()
        if not u.no_password and _hash(password, u.salt) != u.pw_hash:
            raise ErrAuthFailed()
        if self.jwt is not None:
            if self.jwt.verify_only:
                # a public-key provider can check tokens but not mint:
                # this is a server config issue, not a bad credential
                raise AuthError(
                    "jwt provider is verify-only (public key "
                    "configured): this server cannot mint tokens")
            return self.jwt.assign(name, self.revision, self.now)
        token = f"{name}.{secrets.token_hex(16)}"
        self.tokens[token] = (name, self.revision, self.now + self.TOKEN_TTL)
        return token

    # Transport-injected certificate identities: the gateway prefixes
    # the verified client-cert CN with this namespace (and strips any
    # wire-supplied "cert:" Authorization header, so only the TLS layer
    # can mint one). AuthInfoFromTLS (server/auth/store.go:985-1020):
    # the CN is the username at the CURRENT auth revision, no password.
    CERT_TOKEN_PREFIX = "cert:"

    def auth_info(self, token: str) -> tuple[str, int]:
        """(username, revision) for a live token."""
        if token.startswith(self.CERT_TOKEN_PREFIX):
            return token[len(self.CERT_TOKEN_PREFIX):], self.revision
        if self.jwt is not None:
            return self.jwt.info(token, self.now)
        v = self.tokens.get(token)
        if v is None:
            raise ErrInvalidAuthToken()
        name, rev, exp = v
        if exp <= self.now:
            del self.tokens[token]
            raise ErrInvalidAuthToken()
        return name, rev

    # -- authz (store.go IsPutPermitted/IsRangePermitted + range_perm_cache) -
    def check(self, token: str, key: bytes, range_end=None, write=False):
        if not self.enabled:
            return
        name, rev = self.auth_info(token)
        if rev < self.revision:
            raise ErrAuthOldRevision()
        self.check_user(name, key, range_end, write)

    def check_user(self, name: str, key: bytes, range_end=None, write=False):
        if not self.enabled:
            return
        u = self.users.get(name)
        if u is None:
            raise ErrUserNotFound(name)
        if self.ROOT_ROLE in u.roles:
            return
        tree = self._perm_cache(name, write)
        try:
            want = self._req_interval(key, range_end)
        except ValueError:
            # degenerate request range (range_end <= key): nothing can
            # grant it — deny, don't propagate adt's construction error
            raise ErrPermissionDenied(name)
        # checkKeyInterval over UNIFIED ranges (range_perm_cache.go:
        # 104-120): a request spanning several abutting grants passes —
        # per-permission containment would wrongly deny it
        if tree.contains(want):
            return
        raise ErrPermissionDenied(name)

    @staticmethod
    def _req_interval(key: bytes, range_end):
        from etcd_tpu_torch.utils import adt

        if range_end is None:
            return adt.point(key)
        if range_end == b"\x00":
            return adt.Interval(key, adt.INF)
        return adt.Interval(key, range_end)

    def _perm_cache(self, name: str, write: bool):
        """Per-(user, op) unified interval tree, rebuilt when the auth
        revision moves (rangePermCache + invalidation on any auth
        mutation, range_perm_cache.go:24-60)."""
        from etcd_tpu_torch.utils import adt

        cached = self._perm_trees.get((name, write))
        if cached is not None and cached[0] == self.revision:
            return cached[1]
        tree = adt.IntervalTree()
        u = self.users.get(name)
        want = WRITE if write else READ
        for rname in (u.roles if u else ()):
            r = self.roles.get(rname)
            if r is None:
                continue
            for p in r.perms:
                if p.perm_type != READWRITE and p.perm_type != want:
                    continue
                try:
                    tree.insert(self._req_interval(p.key, p.range_end), p)
                except ValueError:
                    # a degenerate stored grant (role_grant_permission
                    # does no validation) must not break every authz
                    # check for the user — it simply grants nothing
                    continue
        self._perm_trees[(name, write)] = (self.revision, tree)
        return tree

    def is_admin(self, token: str) -> None:
        if not self.enabled:
            return
        name, rev = self.auth_info(token)
        if rev < self.revision:
            raise ErrAuthOldRevision()
        u = self.users.get(name)
        if u is None:
            raise ErrUserNotFound(name)
        if self.ROOT_ROLE not in u.roles:
            raise ErrPermissionDenied(name)
