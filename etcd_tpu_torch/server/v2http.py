"""The v2 REST façade — /v2/keys, /v2/members, /v2/stats
(etcd_tpu/server/v2http.py).

Re-design of ``server/etcdserver/api/v2http`` (client.go keysHandler +
parseKeyRequest:346-527, membersHandler, statsHandler) for this
framework's gateway: requests arrive as (method, path, form) triples —
from the JSON/query HTTP server or in-process from clientv2 — and are
parsed with the reference's exact validation ladder and error codes,
then routed through :class:`EtcdCluster`'s consensus front (writes and
quorum reads) or served from the applied tree (plain reads).

Watch (GET ?wait=true) follows this gateway's long-poll convention (see
server/v3rpc.py's watch): if the event is already in history it returns
immediately; otherwise the watcher parks in a registry and the client
polls ``watch_poll`` — the blocking-HTTP analog collapsed to polling,
like the v3 façade's JSON long-poll stands in for gRPC streams.
"""
from __future__ import annotations

import time
from typing import Any

from etcd_tpu_torch.models.changer import ConfChangeError
from etcd_tpu_torch.server.kvserver import EtcdCluster, ServerError
from etcd_tpu_torch.server.v2store import (
    _clean_path,
    EcodeIndexNaN,
    EcodeInvalidField,
    EcodePrevValueRequired,
    EcodeRaftInternal,
    EcodeRefreshTTLRequired,
    EcodeRefreshValue,
    EcodeTTLNaN,
    EcodeUnauthorized,
    EcodeWatcherCleared,
    Event,
    V2Error,
)

KEYS_PREFIX = "/v2/keys"


def _strlist(v) -> list[str] | None:
    """Form lists arrive either as JSON lists or comma strings."""
    if v is None or v == "":
        return None
    if isinstance(v, list):
        return [str(x) for x in v]
    return [s for s in str(v).split(",") if s]


def _get_bool(form: dict, name: str) -> bool:
    """getBool (v2http/http.go): absent = false, 'true'/'false' only."""
    v = form.get(name)
    if v is None:
        return False
    if isinstance(v, bool):
        return v
    if v == "true":
        return True
    if v == "false":
        return False
    raise V2Error(EcodeInvalidField, f'invalid value for "{name}"')


def _get_uint(form: dict, name: str, code: int) -> int:
    v = form.get(name)
    if v is None or v == "":
        return 0
    try:
        i = int(v)
        if i < 0:
            raise ValueError
        return i
    except (TypeError, ValueError):
        raise V2Error(code, f'invalid value for "{name}"') from None


def parse_key_request(method: str, form: dict) -> dict:
    """parseKeyRequest (v2http/client.go:346-527): the validation ladder,
    same codes, same order. Returns the RequestV2-shaped dict."""
    prev_index = _get_uint(form, "prevIndex", EcodeIndexNaN)
    wait_index = _get_uint(form, "waitIndex", EcodeIndexNaN)
    recursive = _get_bool(form, "recursive")
    sorted_ = _get_bool(form, "sorted")
    wait = _get_bool(form, "wait")
    dir_ = _get_bool(form, "dir")
    quorum = _get_bool(form, "quorum")
    stream = _get_bool(form, "stream")
    if wait and method != "GET":
        raise V2Error(EcodeInvalidField,
                      '"wait" can only be used with GET requests')
    prev_value = form.get("prevValue", "")
    if "prevValue" in form and prev_value == "":
        raise V2Error(EcodePrevValueRequired,
                      '"prevValue" cannot be empty')
    no_value_on_success = _get_bool(form, "noValueOnSuccess")
    ttl = None
    if form.get("ttl") not in (None, ""):
        ttl = _get_uint(form, "ttl", EcodeTTLNaN)
    prev_exist = None
    if "prevExist" in form:
        prev_exist = _get_bool(form, "prevExist")
    refresh = None
    if "refresh" in form:
        refresh = _get_bool(form, "refresh")
        if refresh:
            if form.get("value"):
                raise V2Error(EcodeRefreshValue,
                              "A value was provided on a refresh")
            if ttl is None:
                raise V2Error(EcodeRefreshTTLRequired, "No TTL value set")
    return {
        "method": method, "value": form.get("value", ""), "dir": dir_,
        "prev_value": prev_value, "prev_index": prev_index,
        "prev_exist": prev_exist, "wait": wait, "wait_index": wait_index,
        "recursive": recursive, "sorted": sorted_, "quorum": quorum,
        "stream": stream, "refresh": bool(refresh), "ttl": ttl,
        "no_value_on_success": no_value_on_success,
    }


class V2Api:
    """keysHandler + membersHandler + statsHandler + the v2auth admin
    surface (client_auth.go) over EtcdCluster."""

    # Parked long-poll watchers that the client never polls again would
    # otherwise leak until their 100-event overflow: evict after
    # PARK_TTL seconds without a poll, and bound the registry size.
    # The TTL scan itself is throttled to SWEEP_EVERY (it is on the
    # long-poll hot path); the cap check runs every time.
    PARK_TTL = 300.0
    PARK_CAP = 1024
    SWEEP_EVERY = 1.0

    def __init__(self, ec: EtcdCluster):
        from etcd_tpu_torch.server.v2auth import V2AuthStore

        self.ec = ec
        self.auth = V2AuthStore(ec)
        self._watches: dict[int, Any] = {}
        self._watch_seen: dict[int, float] = {}
        self._last_sweep = 0.0
        self._next_watch = 1

    @staticmethod
    def _creds(form: dict) -> tuple[str, str] | None:
        ba = form.get("_basic_auth")
        if not ba:
            return None
        user, _, pw = ba.partition(":")
        return (user, pw)

    # ------------------------------------------------------------- keys
    def keys(self, method: str, key: str,
             form: dict | None = None) -> tuple[int, dict, dict]:
        """One /v2/keys request. Returns (status, body, headers)."""
        from etcd_tpu_torch.server.v2auth import AuthError

        form = form or {}
        # Canonicalize BEFORE the auth guard: the store cleans the path
        # at apply time, so guarding the raw string would let
        # //_security/... or /a/../_security/... slip past both the
        # /_security prefix check and pattern matching (the reference
        # gets this from Go's mux canonicalization + path.Join before
        # any store access).
        key = _clean_path(key)
        try:
            r = parse_key_request(method, form)
            # the basic-auth guard (client_auth.go hasKeyPrefixAccess)
            self.auth.check_key_access(
                self._creds(form), key, write=method != "GET",
                recursive=r["recursive"])
            if method == "GET":
                return self._get(key, r)
            if method in ("PUT", "POST", "DELETE"):
                ev = self.ec.v2_request(
                    method, key, val=r["value"], dir=r["dir"],
                    prev_value=r["prev_value"],
                    prev_index=r["prev_index"],
                    prev_exist=r["prev_exist"],
                    recursive=r["recursive"], sorted_=r["sorted"],
                    refresh=r["refresh"], ttl=r["ttl"])
                return self._key_event(ev, r)
            raise V2Error(EcodeInvalidField, f"bad method {method}")
        except AuthError as e:
            # writeNoAuth: surface as the 110 Unauthorized v2 error
            err = V2Error(EcodeUnauthorized, str(e),
                          self._store().current_index)
            return e.status, err.to_json(), self._headers()
        except V2Error as e:
            return e.status_code(), e.to_json(), self._headers()
        except ServerError as e:
            err = V2Error(EcodeRaftInternal, str(e),
                          self._store().current_index)
            return err.status_code(), err.to_json(), self._headers()

    def _store(self):
        return self.ec.members[self.ec.ensure_leader()].v2store

    def _headers(self) -> dict:
        st = self._store()
        return {"X-Etcd-Index": st.current_index}

    def _key_event(self, ev: Event, r: dict) -> tuple[int, dict, dict]:
        # writeKeyEvent: 201 on create, else 200; noValueOnSuccess trims
        status = 201 if ev.is_created() else 200
        body = ev.to_json()
        if r.get("no_value_on_success"):
            body = dict(body)
            node = dict(body["node"])
            node.pop("value", None)
            node.pop("nodes", None)
            body["node"] = node
            body.pop("prevNode", None)
        return status, body, self._headers()

    def _get(self, key: str, r: dict) -> tuple[int, dict, dict]:
        if r["wait"]:
            return self._watch(key, r)
        if r["quorum"]:
            ev = self.ec.v2_request("QGET", key, recursive=r["recursive"],
                                    sorted_=r["sorted"])
        else:
            ev = self.ec.v2_get(key, r["recursive"], r["sorted"])
        return 200, ev.to_json(), self._headers()

    def _watch(self, key: str, r: dict) -> tuple[int, dict, dict]:
        w = self.ec.v2_watch(key, recursive=r["recursive"],
                             stream=r["stream"],
                             since_index=r["wait_index"])
        ev = w.poll()
        if ev is not None and not r["stream"]:
            w.remove()
            return 200, ev.to_json(), self._headers()
        self._evict_stale_watches(reserve=1)
        wid = self._next_watch
        self._next_watch += 1
        self._watches[wid] = w
        self._watch_seen[wid] = time.monotonic()
        out: dict[str, Any] = {"watch_id": wid}
        if ev is not None:  # stream watcher with a ready history event
            out["event"] = ev.to_json()
        return 200, out, self._headers()

    def _evict_stale_watches(self, reserve: int = 0) -> None:
        """`reserve` slots are held back for an imminent registration;
        plain polls pass 0 so a registry sitting exactly at PARK_CAP is
        not trimmed by unrelated traffic."""
        now = time.monotonic()
        if now - self._last_sweep >= self.SWEEP_EVERY:
            self._last_sweep = now
            for wid, t in list(self._watch_seen.items()):
                if now - t <= self.PARK_TTL:
                    continue
                w = self._watches.get(wid)
                if w is None or w.cleared:
                    # poisoned tombstone outlived its grace window
                    # unclaimed: drop it for good
                    self.watch_cancel(wid)
                else:
                    # free the store-side watcher now, but keep a
                    # poisoned tombstone for one more TTL window so a
                    # returning client gets EcodeWatcherCleared (the
                    # re-watch signal) instead of a bare miss
                    w.cleared = True
                    w.remove()
                    self._watch_seen[wid] = now
        # over cap even after the TTL pass: shed dead tombstones first,
        # then oldest live watches
        excess = len(self._watches) - (self.PARK_CAP - reserve)
        if excess > 0:
            order = sorted(
                self._watch_seen,
                key=lambda i: (not self._watches[i].cleared,
                               self._watch_seen[i]))
            for wid in order[:excess]:
                self.watch_cancel(wid)

    def watch_poll(self, watch_id: int) -> tuple[int, dict, dict]:
        w = self._watches.get(watch_id)
        if w is not None:
            # refresh BEFORE the sweep so a poll always keeps its own
            # watch alive, even arriving just past PARK_TTL
            self._watch_seen[watch_id] = time.monotonic()
        self._evict_stale_watches()
        if w is None:
            # cap-shed, cancelled, or tombstone expired: same 400 +
            # cleared errorCode as the poisoned path, so every "this
            # watch is gone, re-watch" condition looks identical
            err = V2Error(EcodeWatcherCleared, "unknown or evicted watch",
                          self._store().current_index)
            return err.status_code(), err.to_json(), self._headers()
        try:
            ev = w.poll()
        except V2Error as e:
            # EcodeWatcherCleared after recovery/overflow/eviction:
            # surface the error once with the current store index (the
            # v2 re-watch recipe is waitIndex=index+1), then forget the
            # watch (store.go WatcherHub clear semantics)
            if not e.index:
                e.index = self._store().current_index
            self.watch_cancel(watch_id)
            return e.status_code(), e.to_json(), self._headers()
        if ev is None:
            return 200, {}, self._headers()
        if not w.stream:
            w.remove()
            del self._watches[watch_id]
            self._watch_seen.pop(watch_id, None)
        return 200, {"event": ev.to_json()}, self._headers()

    def watch_cancel(self, watch_id: int) -> None:
        w = self._watches.pop(watch_id, None)
        self._watch_seen.pop(watch_id, None)
        if w is not None:
            w.remove()

    # ---------------------------------------------------------- members
    def members(self, method: str, suffix: str = "",
                form: dict | None = None) -> tuple[int, dict, dict]:
        form = form or {}
        try:
            if method == "GET":
                cfg = self.ec.member_config()
                return 200, {"members": [
                    {"id": str(i), "name": f"member{i}",
                     "isLearner": i in cfg.learners}
                    for i in sorted(cfg.progress)
                ]}, self._headers()
            if method == "POST":
                mid = int(form["id"])
                self.ec.member_add(mid,
                                   learner=bool(form.get("isLearner")))
                return 201, {"id": str(mid)}, self._headers()
            if method == "DELETE":
                self.ec.member_remove(int(suffix.strip("/")))
                return 204, {}, self._headers()
            return 405, {"error": "method not allowed"}, self._headers()
        except (ServerError, ConfChangeError, ValueError, KeyError) as e:
            return 500, {"message": str(e)}, self._headers()

    # ------------------------------------------------------- auth admin
    def auth_admin(self, method: str, path: str,
                   form: dict | None = None) -> tuple[int, dict, dict]:
        """/v2/auth/{enable,users[/name],roles[/name]} — the
        client_auth.go handler surface. Admin ops require root once
        auth is enabled (hasRootAccess)."""
        from etcd_tpu_torch.server.v2auth import AuthError

        form = form or {}
        creds = self._creds(form)
        a = self.auth
        try:
            if not a.is_root(creds):
                raise AuthError(401, "permission denied")
            parts = [p for p in path.strip("/").split("/") if p]
            kind = parts[0] if parts else ""
            name = parts[1] if len(parts) > 1 else None
            if kind == "enable":
                if method == "GET":
                    return 200, {"enabled": a.auth_enabled()}, \
                        self._headers()
                if method == "PUT":
                    a.enable_auth()
                    return 200, {"enabled": True}, self._headers()
                if method == "DELETE":
                    a.disable_auth()
                    return 200, {"enabled": False}, self._headers()
            if kind == "users":
                if method == "GET" and name is None:
                    return 200, {"users": a.all_users()}, self._headers()
                if method == "GET":
                    u = dict(a.get_user(name))
                    u.pop("password", None)
                    return 200, u, self._headers()
                if method == "PUT":
                    if form.get("grant") or form.get("revoke") or \
                            a._get(f"/users/{name}") is not None:
                        out = a.update_user(
                            name, password=form.get("password"),
                            grant=_strlist(form.get("grant")),
                            revoke=_strlist(form.get("revoke")))
                        return 200, out, self._headers()
                    out = a.create_user(
                        name, form.get("password", ""),
                        _strlist(form.get("roles")))
                    return 201, out, self._headers()
                if method == "DELETE":
                    a.delete_user(name)
                    return 200, {}, self._headers()
            if kind == "roles":
                if method == "GET" and name is None:
                    return 200, {"roles": a.all_roles()}, self._headers()
                if method == "GET":
                    return 200, a.get_role(name), self._headers()
                if method == "PUT":
                    if form.get("grant") or form.get("revoke"):
                        out = a.update_role(name,
                                            grant=form.get("grant"),
                                            revoke=form.get("revoke"))
                        return 200, out, self._headers()
                    out = a.create_role(name, form.get("permissions"))
                    return 201, out, self._headers()
                if method == "DELETE":
                    a.delete_role(name)
                    return 200, {}, self._headers()
            return 404, {"message": f"unknown auth path {path}"}, \
                self._headers()
        except AuthError as e:
            return e.status, {"message": str(e)}, self._headers()

    # ------------------------------------------------------------ stats
    def stats(self, which: str) -> tuple[int, dict, dict]:
        if which == "store":
            return 200, self.ec.v2_stats(), self._headers()
        if which == "self":
            lead = self.ec.ensure_leader()
            return 200, {"id": str(lead), "state": "StateLeader"}, \
                self._headers()
        if which == "leader":
            lead = self.ec.ensure_leader()
            return 200, {"leader": str(lead)}, self._headers()
        return 404, {"error": f"unknown stats {which}"}, self._headers()
