"""The legacy v2 store — an in-memory hierarchical key tree.

Re-design of ``server/etcdserver/api/v2store`` (store.go, node.go,
event.go, event_history.go, watcher.go, watcher_hub.go, ttl_key_heap.go)
for this framework: the store is the *applied state machine* behind the
batched device consensus engine — every mutation arrives as a committed
v2 request (see kvserver's ``kind == "v2"`` dispatch, the applyV2Request
analog of apply_v2.go:124-148) so all members hold bit-identical trees.

Host-side by design: like MVCC, the v2 tree is irregular pointer-chasing
state that belongs on the host; the device fleet carries the replicated
log that orders its mutations (SURVEY §2.4 — apply is host work).

Differences from the reference, all deliberate:
- Nodes are plain Python objects; NodeExtern reprs are JSON-ready dicts.
- Watchers buffer events in a deque (capacity 100, overflow removes the
  watcher — watcher.go:63-72's closed-channel rule) instead of channels;
  the gateway long-polls them like the v3 watch façade.
- Time is a float-seconds clock injected by the server so TTL math stays
  deterministic under test clocks; proposed requests carry an absolute
  expiration, exactly like RequestV2.Expiration (apply_v2.go:150-157).

The port's copy of etcd_tpu/server/v2store.py, which it imports nothing of.
"""
from __future__ import annotations

import heapq
import json
import math
import time as _time
from collections import deque
from typing import Any, Callable

# ---------------------------------------------------------------- errors
# v2error/error.go:83-106 code points + :27-63 messages

EcodeKeyNotFound = 100
EcodeTestFailed = 101
EcodeNotFile = 102
EcodeNotDir = 104
EcodeNodeExist = 105
EcodeRootROnly = 107
EcodeDirNotEmpty = 108
EcodeUnauthorized = 110
EcodePrevValueRequired = 201
EcodeTTLNaN = 202
EcodeIndexNaN = 203
EcodeInvalidField = 209
EcodeInvalidForm = 210
EcodeRefreshValue = 211
EcodeRefreshTTLRequired = 212
EcodeRaftInternal = 300
EcodeLeaderElect = 301
EcodeWatcherCleared = 400
EcodeEventIndexCleared = 401

_MESSAGES = {
    EcodeKeyNotFound: "Key not found",
    EcodeTestFailed: "Compare failed",
    EcodeNotFile: "Not a file",
    EcodeNotDir: "Not a directory",
    EcodeNodeExist: "Key already exists",
    EcodeRootROnly: "Root is read only",
    EcodeDirNotEmpty: "Directory not empty",
    EcodeUnauthorized: "The request requires user authentication",
    EcodePrevValueRequired: "PrevValue is Required in POST form",
    EcodeTTLNaN: "The given TTL in POST form is not a number",
    EcodeIndexNaN: "The given index in POST form is not a number",
    EcodeInvalidField: "Invalid field",
    EcodeInvalidForm: "Invalid POST form",
    EcodeRefreshValue: "Value provided on refresh",
    EcodeRefreshTTLRequired: "A TTL must be provided on refresh",
    EcodeRaftInternal: "Raft Internal Error",
    EcodeLeaderElect: "During Leader Election",
    EcodeWatcherCleared: "watcher is cleared due to etcd recovery",
    EcodeEventIndexCleared:
        "The event in requested index is outdated and cleared",
}

# HTTP status mapping (v2error/error.go:71-80; default 400)
_HTTP_STATUS = {
    EcodeKeyNotFound: 404,
    EcodeNotFile: 403,
    EcodeDirNotEmpty: 403,
    EcodeUnauthorized: 401,
    EcodeTestFailed: 412,
    EcodeNodeExist: 412,
    EcodeRaftInternal: 500,
    EcodeLeaderElect: 500,
}


class V2Error(Exception):
    """v2error.Error: code + cause + the store index at raise time."""

    def __init__(self, code: int, cause: str = "", index: int = 0):
        self.code = code
        self.cause = cause
        self.index = index
        super().__init__(f"{_MESSAGES.get(code, f'code {code}')} ({cause})"
                         f" [{index}]")

    @property
    def message(self) -> str:
        return _MESSAGES.get(self.code, f"code {self.code}")

    def status_code(self) -> int:
        return _HTTP_STATUS.get(self.code, 400)

    def to_json(self) -> dict:
        return {"errorCode": self.code, "message": self.message,
                "cause": self.cause, "index": self.index}


# ---------------------------------------------------------------- events
# event.go:17-26 action names

GET = "get"
CREATE = "create"
SET = "set"
UPDATE = "update"
DELETE = "delete"
COMPARE_AND_SWAP = "compareAndSwap"
COMPARE_AND_DELETE = "compareAndDelete"
EXPIRE = "expire"

PERMANENT = None  # node.ExpireTime zero-value analog


def _clean_path(p: str) -> str:
    """path.Clean(path.Join("/", p)) — collapse //, resolve ., .., root it."""
    parts: list[str] = []
    for comp in p.split("/"):
        if comp in ("", "."):
            continue
        if comp == "..":
            if parts:
                parts.pop()
            continue
        parts.append(comp)
    return "/" + "/".join(parts)


def _split_path(p: str) -> tuple[str, str]:
    """path.Split: (dir with trailing slash semantics collapsed, base)."""
    p = _clean_path(p)
    if p == "/":
        return "/", ""
    i = p.rfind("/")
    return (p[:i] or "/"), p[i + 1:]


class Event:
    """event.go Event: action + node repr + optional prevNode repr."""

    __slots__ = ("action", "node", "prev_node", "etcd_index", "refresh")

    def __init__(self, action: str, node: dict,
                 prev_node: dict | None = None, etcd_index: int = 0,
                 refresh: bool = False):
        self.action = action
        self.node = node
        self.prev_node = prev_node
        self.etcd_index = etcd_index
        self.refresh = refresh

    def index(self) -> int:
        return self.node.get("modifiedIndex", 0)

    def is_created(self) -> bool:
        # event.go:49-54
        if self.action == CREATE:
            return True
        return self.action == SET and self.prev_node is None

    def clone(self) -> "Event":
        return Event(self.action, dict(self.node),
                     dict(self.prev_node) if self.prev_node else None,
                     self.etcd_index, self.refresh)

    def to_json(self) -> dict:
        out = {"action": self.action, "node": self.node}
        if self.prev_node is not None:
            out["prevNode"] = self.prev_node
        return out


class Node:
    """node.go node: one tree vertex — KV (children is None) or dir."""

    __slots__ = ("path", "value", "children", "created_index",
                 "modified_index", "expire_time", "parent", "store")

    def __init__(self, store: "V2Store", path: str, created: int,
                 parent: "Node | None", expire_time: float | None,
                 value: str | None = None, is_dir: bool = False):
        self.store = store
        self.path = path
        self.created_index = created
        self.modified_index = created
        self.parent = parent
        self.expire_time = expire_time
        if is_dir:
            self.children: dict[str, Node] | None = {}
            self.value = ""
        else:
            self.children = None
            self.value = value or ""

    # ---- predicates (node.go:87-108)
    def is_dir(self) -> bool:
        return self.children is not None

    def is_permanent(self) -> bool:
        return self.expire_time is None

    def is_hidden(self) -> bool:
        _, name = _split_path(self.path)
        return name.startswith("_")

    # ---- accessors
    def write(self, value: str, index: int) -> None:
        if self.is_dir():
            raise V2Error(EcodeNotFile, "", self.store.current_index)
        self.value = value
        self.modified_index = index

    def expiration_and_ttl(self, now: float) -> tuple[str | None, int]:
        """node.go:131-151 — ttl = ceil(expire - now), floor 1s range."""
        if self.is_permanent():
            return None, 0
        ttl = math.ceil(self.expire_time - now)
        iso = _time.strftime("%Y-%m-%dT%H:%M:%SZ",
                             _time.gmtime(self.expire_time))
        return iso, int(ttl)

    def get_child(self, name: str) -> "Node | None":
        if not self.is_dir():
            raise V2Error(EcodeNotDir, self.path, self.store.current_index)
        return self.children.get(name)

    def add(self, child: "Node") -> None:
        if not self.is_dir():
            raise V2Error(EcodeNotDir, "", self.store.current_index)
        _, name = _split_path(child.path)
        if name in self.children:
            raise V2Error(EcodeNodeExist, "", self.store.current_index)
        self.children[name] = child

    def remove(self, dir: bool, recursive: bool,
               callback: Callable[[str], None] | None) -> None:
        """node.go:206-256 — delete self (and children when recursive)."""
        if not self.is_dir():
            _, name = _split_path(self.path)
            if self.parent is not None and \
                    self.parent.children.get(name) is self:
                del self.parent.children[name]
            if callback:
                callback(self.path)
            if not self.is_permanent():
                self.store._ttl_heap_remove(self)
            return
        if not dir:
            raise V2Error(EcodeNotFile, self.path, self.store.current_index)
        if self.children and not recursive:
            raise V2Error(EcodeDirNotEmpty, self.path,
                          self.store.current_index)
        for child in list(self.children.values()):
            child.remove(True, True, callback)
        _, name = _split_path(self.path)
        if self.parent is not None and \
                self.parent.children.get(name) is self:
            del self.parent.children[name]
            if callback:
                callback(self.path)
            if not self.is_permanent():
                self.store._ttl_heap_remove(self)

    def update_ttl(self, expire_time: float | None) -> None:
        """node.go:311-338 — move between permanent and TTL'd."""
        if not self.is_permanent():
            if expire_time is None:
                self.expire_time = None
                self.store._ttl_heap_remove(self)
            else:
                self.expire_time = expire_time
                self.store._ttl_heap_push(self)  # re-key (lazy heap)
            return
        if expire_time is None:
            return
        self.expire_time = expire_time
        self.store._ttl_heap_push(self)

    def compare(self, prev_value: str, prev_index: int) -> tuple[bool, int]:
        """node.go:340-358 — '' / 0 are wildcards; returns (ok, which)."""
        index_match = prev_index == 0 or self.modified_index == prev_index
        value_match = prev_value == "" or self.value == prev_value
        if value_match and index_match:
            return True, 0
        if value_match and not index_match:
            return False, 1  # CompareIndexNotMatch
        if index_match and not value_match:
            return False, 2  # CompareValueNotMatch
        return False, 3  # CompareNotMatch

    def extern(self, recursive: bool, sorted_: bool, now: float) -> dict:
        """loadInternalNode (node_extern.go:38-70): the GET top-level
        repr — a dir ALWAYS lists its direct children (hidden skipped);
        `recursive` only controls whether those children recurse."""
        if not self.is_dir():
            return self.repr(False, False, now)
        out: dict[str, Any] = {
            "key": self.path, "dir": True,
            "modifiedIndex": self.modified_index,
            "createdIndex": self.created_index,
        }
        exp, ttl = self.expiration_and_ttl(now)
        if exp is not None:
            out["expiration"], out["ttl"] = exp, ttl
        nodes = [c.repr(recursive, sorted_, now)
                 for c in self.children.values() if not c.is_hidden()]
        if sorted_:
            nodes.sort(key=lambda n: n["key"])
        out["nodes"] = nodes
        return out

    # ---- repr (node.go:258-310)
    def repr(self, recursive: bool, sorted_: bool, now: float) -> dict:
        if self.is_dir():
            out: dict[str, Any] = {
                "key": self.path, "dir": True,
                "modifiedIndex": self.modified_index,
                "createdIndex": self.created_index,
            }
            exp, ttl = self.expiration_and_ttl(now)
            if exp is not None:
                out["expiration"], out["ttl"] = exp, ttl
            if not recursive:
                return out
            nodes = [c.repr(recursive, sorted_, now)
                     for c in self.children.values() if not c.is_hidden()]
            if sorted_:
                nodes.sort(key=lambda n: n["key"])
            out["nodes"] = nodes
            return out
        out = {
            "key": self.path, "value": self.value,
            "modifiedIndex": self.modified_index,
            "createdIndex": self.created_index,
        }
        exp, ttl = self.expiration_and_ttl(now)
        if exp is not None:
            out["expiration"], out["ttl"] = exp, ttl
        return out

    # ---- save/recover (store.go:739-789)
    def to_save(self) -> dict:
        out: dict[str, Any] = {
            "path": self.path, "createdIndex": self.created_index,
            "modifiedIndex": self.modified_index,
        }
        if self.expire_time is not None:
            out["expireTime"] = self.expire_time
        if self.is_dir():
            out["dir"] = True
            out["children"] = [c.to_save() for c in self.children.values()]
        else:
            out["value"] = self.value
        return out

    @classmethod
    def from_save(cls, store: "V2Store", d: dict,
                  parent: "Node | None") -> "Node":
        n = cls(store, d["path"], d["createdIndex"], parent,
                d.get("expireTime"), d.get("value"), d.get("dir", False))
        n.modified_index = d["modifiedIndex"]
        if n.is_dir():
            for c in d.get("children", []):
                child = cls.from_save(store, c, n)
                _, name = _split_path(child.path)
                n.children[name] = child
        return n


def _compare_fail_cause(n: Node, which: int, prev_value: str,
                        prev_index: int) -> str:
    # store.go:246-256 getCompareFailCause
    if which == 1:
        return f"[{prev_index} != {n.modified_index}]"
    if which == 2:
        return f"[{prev_value} != {n.value}]"
    return (f"[{prev_value} != {n.value}]"
            f" [{prev_index} != {n.modified_index}]")


# --------------------------------------------------------- event history

class EventHistory:
    """event_history.go: ring of the last `capacity` events so watchers
    can resume from a past index (EcodeEventIndexCleared past the ring)."""

    def __init__(self, capacity: int = 1000):
        self.capacity = capacity
        self.events: deque[Event] = deque(maxlen=capacity)
        self.start_index = 0
        self.last_index = 0

    def add(self, e: Event) -> Event:
        self.events.append(e)
        self.last_index = e.index()
        self.start_index = self.events[0].index()
        return e

    def scan(self, key: str, recursive: bool,
             index: int) -> Event | None:
        """event_history.go:57-107 — first event ≥ index touching key."""
        if index < self.start_index:
            raise V2Error(
                EcodeEventIndexCleared,
                f"the requested history has been cleared "
                f"[{self.start_index}/{index}]", 0)
        if index > self.last_index:  # future index
            return None
        for e in self.events:
            if e.index() < index or e.refresh:
                continue
            ok = e.node["key"] == key
            if recursive:
                nkey = key if key.endswith("/") else key + "/"
                ok = ok or e.node["key"].startswith(nkey)
            if e.action in (DELETE, EXPIRE) and e.prev_node is not None \
                    and e.prev_node.get("dir"):
                ok = ok or key.startswith(e.prev_node["key"])
            if ok:
                return e
        return None

    def clone(self) -> "EventHistory":
        eh = EventHistory(self.capacity)
        eh.events = deque(self.events, maxlen=self.capacity)
        eh.start_index = self.start_index
        eh.last_index = self.last_index
        return eh


# --------------------------------------------------------------- watcher

class Watcher:
    """watcher.go watcher — deque-buffered (capacity = channel size 100;
    overflow removes the watcher, the closed-channel rule)."""

    CAPACITY = 100

    def __init__(self, hub: "WatcherHub", key: str, recursive: bool,
                 stream: bool, since_index: int, start_index: int):
        self.hub = hub
        self.key = key
        self.recursive = recursive
        self.stream = stream
        self.since_index = since_index
        self.start_index = start_index  # EtcdIndex at creation
        self.events: deque[Event] = deque()
        self.removed = False
        self.cleared = False  # poisoned by recovery(); next poll errors

    def notify(self, e: Event, original_path: bool, deleted: bool) -> bool:
        # watcher.go:43-75 interest predicate
        if (self.recursive or original_path or deleted) \
                and e.index() >= self.since_index:
            if len(self.events) >= self.CAPACITY:
                # missed a notification: drop the watcher, and poison it
                # so a client still polling gets EcodeWatcherCleared once
                # the buffer drains instead of silent empty polls forever
                # (the reference closes the event channel here)
                self.cleared = True
                self.remove()
                return True
            self.events.append(e)
            return True
        return False

    def poll(self) -> Event | None:
        """Drain one event (the gateway's long-poll read)."""
        if self.events:
            return self.events.popleft()
        if self.cleared:
            # store.go WatcherHub.clone/recovery drops the hub; clients
            # get EcodeWatcherCleared so they know to re-watch
            raise V2Error(EcodeWatcherCleared,
                          "the watcher is cleared on store recovery")
        return None

    def remove(self) -> None:
        if not self.removed:
            self.removed = True
            self.hub._detach(self)


def _is_hidden(watch_path: str, key_path: str) -> bool:
    """watcher_hub.go isHidden: ANY component of keyPath below watchPath
    starting with '_' hides the event (watching /a recursively must not
    see /a/b/_h, not just /a/_h)."""
    if len(watch_path) > len(key_path):
        return False
    after = key_path[len(watch_path):].lstrip("/")
    return any(seg.startswith("_") for seg in after.split("/") if seg)


class WatcherHub:
    """watcher_hub.go — path → watcher list + shared event history."""

    def __init__(self, capacity: int = 1000):
        self.watchers: dict[str, list[Watcher]] = {}
        self.history = EventHistory(capacity)
        self.count = 0

    def watch(self, key: str, recursive: bool, stream: bool,
              index: int, store_index: int) -> Watcher:
        event = self.history.scan(key, recursive, index)  # may raise 401
        w = Watcher(self, key, recursive, stream, index, store_index)
        if event is not None:
            ne = event.clone()
            ne.etcd_index = store_index
            w.events.append(ne)
            return w
        self.watchers.setdefault(key, []).append(w)
        self.count += 1
        return w

    def _detach(self, w: Watcher) -> None:
        lst = self.watchers.get(w.key)
        if lst and w in lst:
            lst.remove(w)
            self.count -= 1
            if not lst:
                del self.watchers[w.key]

    def add(self, e: Event) -> None:
        """Refresh events enter history but notify nobody
        (watcher_hub.go:118-120 + store.go refresh branches)."""
        self.history.add(e)

    def notify(self, e: Event) -> None:
        # watcher_hub.go:122-141: notify every ancestor path
        e = self.history.add(e)
        segments = [s for s in e.node["key"].split("/") if s]
        curr = "/"
        self.notify_watchers(e, curr, False)
        for seg in segments:
            curr = curr.rstrip("/") + "/" + seg
            self.notify_watchers(e, curr, False)

    def notify_watchers(self, e: Event, node_path: str,
                        deleted: bool) -> None:
        lst = self.watchers.get(node_path)
        if not lst:
            return
        for w in list(lst):
            original_path = e.node["key"] == node_path
            if (original_path or not _is_hidden(node_path, e.node["key"])) \
                    and w.notify(e, original_path, deleted):
                if not w.stream:
                    w.removed = True
                    if w in lst:
                        lst.remove(w)
                        self.count -= 1
        if node_path in self.watchers and not self.watchers[node_path]:
            del self.watchers[node_path]

    def clone(self) -> "WatcherHub":
        wh = WatcherHub(self.history.capacity)
        wh.history = self.history.clone()
        return wh


# ----------------------------------------------------------------- stats

_STAT_NAMES = (
    "getsSuccess", "getsFail", "setsSuccess", "setsFail",
    "deleteSuccess", "deleteFail", "updateSuccess", "updateFail",
    "createSuccess", "createFail", "compareAndSwapSuccess",
    "compareAndSwapFail", "compareAndDeleteSuccess",
    "compareAndDeleteFail", "expireCount",
)


class Stats:
    """stats.go Stats — per-op success/fail counters."""

    def __init__(self):
        self.counters = {k: 0 for k in _STAT_NAMES}

    def inc(self, name: str) -> None:
        self.counters[name] += 1

    def to_json(self) -> dict:
        return dict(self.counters)


# ----------------------------------------------------------------- store

class V2Store:
    """store.go store — the v2 tree with a stop-the-world apply model
    (our applies are already serialized by the consensus log, so there is
    no lock: one committed entry at a time mutates the tree)."""

    def __init__(self, namespaces: tuple[str, ...] = (),
                 clock: Callable[[], float] | None = None):
        self.current_version = 2  # defaultVersion (store.go:33)
        self.current_index = 0
        self.clock = clock or _time.time
        self.root = Node(self, "/", self.current_index, None,
                         PERMANENT, is_dir=True)
        for ns in namespaces:
            self.root.add(Node(self, _clean_path(ns), self.current_index,
                               self.root, PERMANENT, is_dir=True))
        self.readonly_set = {"/"} | {_clean_path(ns) for ns in namespaces}
        self.hub = WatcherHub(1000)
        self.stats = Stats()
        # TTL min-heap with lazy invalidation: (expire, seq, node); an
        # entry is live iff the node still carries that expire time and
        # is still attached (ttl_key_heap.go, keyed update collapsed to
        # push-and-skip-stale)
        self._ttl_heap: list[tuple[float, int, Node]] = []
        self._ttl_seq = 0

    # ---- ttl heap helpers
    def _ttl_heap_push(self, n: Node) -> None:
        self._ttl_seq += 1
        heapq.heappush(self._ttl_heap, (n.expire_time, self._ttl_seq, n))

    def _ttl_heap_remove(self, n: Node) -> None:
        pass  # lazy: stale entries are skipped at pop time

    def _ttl_top(self) -> Node | None:
        while self._ttl_heap:
            exp, _, n = self._ttl_heap[0]
            if n.is_permanent() or n.expire_time != exp or self._detached(n):
                heapq.heappop(self._ttl_heap)
                continue
            return n
        return None

    def _detached(self, n: Node) -> bool:
        while n.parent is not None:
            _, name = _split_path(n.path)
            if n.parent.children is None or \
                    n.parent.children.get(name) is not n:
                return True
            n = n.parent
        return n.path != "/"

    # ---- public surface (Store interface, store.go:41-68)
    def version(self) -> int:
        return self.current_version

    def index(self) -> int:
        return self.current_index

    def get(self, node_path: str, recursive: bool = False,
            sorted_: bool = False) -> Event:
        try:
            n = self._internal_get(node_path)
        except V2Error:
            self.stats.inc("getsFail")
            raise
        now = self.clock()
        e = Event(GET, n.extern(recursive, sorted_, now),
                  etcd_index=self.current_index)
        self.stats.inc("getsSuccess")
        return e

    def create(self, node_path: str, dir: bool = False, value: str = "",
               unique: bool = False,
               expire_time: float | None = None) -> Event:
        try:
            e = self._internal_create(node_path, dir, value, unique,
                                      False, expire_time, CREATE)
        except V2Error:
            self.stats.inc("createFail")
            raise
        e.etcd_index = self.current_index
        self.hub.notify(e)
        self.stats.inc("createSuccess")
        return e

    def set(self, node_path: str, dir: bool = False, value: str = "",
            expire_time: float | None = None,
            refresh: bool = False) -> Event:
        try:
            n = None
            try:
                n = self._internal_get(node_path)
            except V2Error as ge:
                if ge.code != EcodeKeyNotFound:
                    raise
                if refresh:
                    raise  # refresh requires an existing node
            if refresh:
                value = n.value
            prev_repr = n.repr(False, False, self.clock()) if n else None
            e = self._internal_create(node_path, dir, value, False, True,
                                      expire_time, SET)
        except V2Error:
            self.stats.inc("setsFail")
            raise
        e.etcd_index = self.current_index
        if prev_repr is not None:
            e.prev_node = prev_repr
        if not refresh:
            self.hub.notify(e)
        else:
            e.refresh = True
            self.hub.add(e)
        self.stats.inc("setsSuccess")
        return e

    def update(self, node_path: str, new_value: str = "",
               expire_time: float | None = None,
               refresh: bool = False) -> Event:
        try:
            node_path = _clean_path(node_path)
            if node_path in self.readonly_set:
                raise V2Error(EcodeRootROnly, "/", self.current_index)
            n = self._internal_get(node_path)
            if n.is_dir():
                # the n.Write call inside Update rejects directories
                # (node.go:120-124), so dir updates always fail NotFile
                raise V2Error(EcodeNotFile, node_path, self.current_index)
            if refresh:
                new_value = n.value
            next_index = self.current_index + 1
            now = self.clock()
            prev = n.repr(False, False, now)
            n.write(new_value, next_index)
            n.update_ttl(expire_time)
            node_repr = {"key": node_path,
                         "modifiedIndex": next_index,
                         "createdIndex": n.created_index,
                         "value": new_value}
            exp, ttl = n.expiration_and_ttl(now)
            if exp is not None:
                node_repr["expiration"], node_repr["ttl"] = exp, ttl
            e = Event(UPDATE, node_repr, prev, next_index)
        except V2Error:
            self.stats.inc("updateFail")
            raise
        if not refresh:
            self.hub.notify(e)
        else:
            e.refresh = True
            self.hub.add(e)
        self.current_index = next_index
        self.stats.inc("updateSuccess")
        return e

    def compare_and_swap(self, node_path: str, prev_value: str,
                         prev_index: int, value: str,
                         expire_time: float | None = None,
                         refresh: bool = False) -> Event:
        try:
            node_path = _clean_path(node_path)
            if node_path in self.readonly_set:
                raise V2Error(EcodeRootROnly, "/", self.current_index)
            n = self._internal_get(node_path)
            if n.is_dir():
                raise V2Error(EcodeNotFile, node_path, self.current_index)
            ok, which = n.compare(prev_value, prev_index)
            if not ok:
                cause = _compare_fail_cause(n, which, prev_value,
                                            prev_index)
                raise V2Error(EcodeTestFailed, cause, self.current_index)
            if refresh:
                value = n.value
            self.current_index += 1
            now = self.clock()
            prev = n.repr(False, False, now)
            n.write(value, self.current_index)
            n.update_ttl(expire_time)
            node_repr = {"key": node_path, "value": value,
                         "modifiedIndex": self.current_index,
                         "createdIndex": n.created_index}
            exp, ttl = n.expiration_and_ttl(now)
            if exp is not None:
                node_repr["expiration"], node_repr["ttl"] = exp, ttl
            e = Event(COMPARE_AND_SWAP, node_repr, prev,
                      self.current_index)
        except V2Error:
            self.stats.inc("compareAndSwapFail")
            raise
        if not refresh:
            self.hub.notify(e)
        else:
            e.refresh = True
            self.hub.add(e)
        self.stats.inc("compareAndSwapSuccess")
        return e

    def delete(self, node_path: str, dir: bool = False,
               recursive: bool = False) -> Event:
        try:
            node_path = _clean_path(node_path)
            if node_path in self.readonly_set:
                raise V2Error(EcodeRootROnly, "/", self.current_index)
            if recursive:  # recursive implies dir
                dir = True
            n = self._internal_get(node_path)
            next_index = self.current_index + 1
            now = self.clock()
            prev = n.repr(False, False, now)
            node_repr = {"key": node_path, "modifiedIndex": next_index,
                         "createdIndex": n.created_index}
            if n.is_dir():
                node_repr["dir"] = True
            e = Event(DELETE, node_repr, prev, next_index)

            def callback(path: str) -> None:
                self.hub.notify_watchers(e, path, True)

            n.remove(dir, recursive, callback)
        except V2Error:
            self.stats.inc("deleteFail")
            raise
        self.current_index = next_index
        self.hub.notify(e)
        self.stats.inc("deleteSuccess")
        return e

    def compare_and_delete(self, node_path: str, prev_value: str,
                           prev_index: int) -> Event:
        try:
            node_path = _clean_path(node_path)
            n = self._internal_get(node_path)
            if n.is_dir():
                raise V2Error(EcodeNotFile, node_path, self.current_index)
            ok, which = n.compare(prev_value, prev_index)
            if not ok:
                cause = _compare_fail_cause(n, which, prev_value,
                                            prev_index)
                raise V2Error(EcodeTestFailed, cause, self.current_index)
            self.current_index += 1
            now = self.clock()
            prev = n.repr(False, False, now)
            e = Event(COMPARE_AND_DELETE,
                      {"key": node_path,
                       "modifiedIndex": self.current_index,
                       "createdIndex": n.created_index},
                      prev, self.current_index)

            def callback(path: str) -> None:
                self.hub.notify_watchers(e, path, True)

            n.remove(False, False, callback)
        except V2Error:
            self.stats.inc("compareAndDeleteFail")
            raise
        self.hub.notify(e)
        self.stats.inc("compareAndDeleteSuccess")
        return e

    def watch(self, key: str, recursive: bool = False,
              stream: bool = False, since_index: int = 0) -> Watcher:
        key = _clean_path(key)
        if since_index == 0:
            since_index = self.current_index + 1
        try:
            return self.hub.watch(key, recursive, stream, since_index,
                                  self.current_index)
        except V2Error as e:
            e.index = self.current_index
            raise

    def delete_expired_keys(self, cutoff: float) -> None:
        """store.go:679-711 — pop TTL heap up to cutoff, emit expire
        events. Driven by committed SYNC requests so all members expire
        identically (v2_server SYNC / apply_v2.go:113-116)."""
        while True:
            n = self._ttl_top()
            if n is None or n.expire_time > cutoff:
                break
            self.current_index += 1
            prev = n.repr(False, False, self.clock())
            node_repr = {"key": n.path,
                         "modifiedIndex": self.current_index,
                         "createdIndex": n.created_index}
            if n.is_dir():
                node_repr["dir"] = True
            e = Event(EXPIRE, node_repr, prev, self.current_index)

            def callback(path: str) -> None:
                self.hub.notify_watchers(e, path, True)

            heapq.heappop(self._ttl_heap)
            n.remove(True, True, callback)
            self.stats.inc("expireCount")
            self.hub.notify(e)

    def has_ttl_keys(self) -> bool:
        return self._ttl_top() is not None

    # ---- persistence (store.go:739-789)
    def save(self) -> str:
        return json.dumps({
            "version": self.current_version,
            "currentIndex": self.current_index,
            "root": self.root.to_save(),
            "readonly": sorted(self.readonly_set),
        })

    def recovery(self, state: str) -> None:
        d = json.loads(state)
        self.current_version = d["version"]
        self.current_index = d["currentIndex"]
        self.readonly_set = set(d.get("readonly", ["/"]))
        self.root = Node.from_save(self, d["root"], None)
        self._ttl_heap = []
        self._ttl_seq = 0
        # Poison live watchers before discarding the hub: their next
        # poll raises EcodeWatcherCleared (the reference's recovery
        # path returns 400 so clients know to re-watch) instead of
        # silently never firing again.
        for ws in self.hub.watchers.values():
            for w in list(ws):
                w.cleared = True
        self.hub = WatcherHub(self.hub.history.capacity)
        self._rebuild_ttl(self.root)

    def _rebuild_ttl(self, n: Node) -> None:
        if not n.is_permanent():
            self._ttl_heap_push(n)
        if n.is_dir():
            for c in n.children.values():
                self._rebuild_ttl(c)

    def clone(self) -> "V2Store":
        s = V2Store(clock=self.clock)
        s.recovery(self.save())
        s.stats.counters = dict(self.stats.counters)
        return s

    def json_stats(self) -> dict:
        out = self.stats.to_json()
        out["watchers"] = self.hub.count
        return out

    # ---- internals
    def _walk(self, node_path: str, walk_fn) -> Node:
        # store.go:471-489
        curr = self.root
        for comp in node_path.split("/"):
            if not comp:
                continue
            curr = walk_fn(curr, comp)
        return curr

    def _internal_get(self, node_path: str) -> Node:
        node_path = _clean_path(node_path)

        def walk_fn(parent: Node, name: str) -> Node:
            if not parent.is_dir():
                raise V2Error(EcodeNotDir, parent.path, self.current_index)
            child = parent.children.get(name)
            if child is None:
                raise V2Error(EcodeKeyNotFound,
                              _clean_path(parent.path + "/" + name),
                              self.current_index)
            return child

        return self._walk(node_path, walk_fn)

    def _check_dir(self, parent: Node, dir_name: str) -> Node:
        # store.go:717-733 — auto-create intermediate permanent dirs
        node = parent.children.get(dir_name)
        if node is not None:
            if node.is_dir():
                return node
            raise V2Error(EcodeNotDir, node.path, self.current_index)
        n = Node(self, _clean_path(parent.path + "/" + dir_name),
                 self.current_index + 1, parent, PERMANENT, is_dir=True)
        parent.children[dir_name] = n
        return n

    def _internal_create(self, node_path: str, dir: bool, value: str,
                         unique: bool, replace: bool,
                         expire_time: float | None,
                         action: str) -> Event:
        # store.go:566-648
        curr_index, next_index = self.current_index, self.current_index + 1
        if unique:  # POST in-order key: zero-padded next index
            node_path += "/" + format(next_index, "020d")
        node_path = _clean_path(node_path)
        if node_path in self.readonly_set:
            raise V2Error(EcodeRootROnly, "/", curr_index)

        dir_name, node_name = _split_path(node_path)
        d = self._walk(dir_name, self._check_dir)

        node_repr: dict[str, Any] = {"key": node_path,
                                     "modifiedIndex": next_index,
                                     "createdIndex": next_index}
        e = Event(action, node_repr)
        n = d.get_child(node_name)
        if n is not None:
            if replace:
                if n.is_dir():
                    raise V2Error(EcodeNotFile, node_path, curr_index)
                e.prev_node = n.repr(False, False, self.clock())
                n.remove(False, False, None)
            else:
                raise V2Error(EcodeNodeExist, node_path, curr_index)

        if not dir:
            node_repr["value"] = value
            n = Node(self, node_path, next_index, d, expire_time,
                     value=value)
        else:
            node_repr["dir"] = True
            n = Node(self, node_path, next_index, d, expire_time,
                     is_dir=True)
        d.add(n)
        if not n.is_permanent():
            self._ttl_heap_push(n)
            exp, ttl = n.expiration_and_ttl(self.clock())
            node_repr["expiration"], node_repr["ttl"] = exp, ttl
        self.current_index = next_index
        return e
