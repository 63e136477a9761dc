"""Link-level fabric interconnect: latency/bandwidth/queuing per link.

The scalar `PolicyConfig.transfer_ms` model prices every cross-shell
move as a constant, so ten thieves hammering one victim see the same
per-chunk cost as one.  `FabricNetwork` replaces it with the
FOS/NoC-style picture (Mbongue et al.: multi-tenant virtual regions
contending on a shared interconnect): shells attach to *ports* on a
switch topology, each directed link carries a fixed `latency_ms` plus
`bw_ms` (milliseconds per unit payload), and links have bounded output
buffers — concurrent transfers on a shared link serialize and queue
rather than overlapping for free.

Two operating modes, one API:

- **uniform** (the compatibility shim): no links at all — a per-pair
  dict plus a fabric-wide default, byte-for-byte the old
  `Fabric._transfer_ms` lookup.  `active` is False, `version` never
  moves, and the whole golden corpus reproduces unchanged.
- **links** (`crossbar` / `from_topology`): routes are precomputed by
  deterministic BFS over the switch graph; `est_transfer_ms` walks the
  route store-and-forward, charging queue wait against each link's
  `busy_until` horizon, and returns `inf` while any link's bounded
  buffer is full (the steal gate's back-off signal).  `reserve`
  realizes a transfer as timed link occupancy; `advance(now)` releases
  expired occupancy (the simulator drives it from heap events, the
  daemon from wall clock) and bumps `version` so the incremental
  scheduler re-dirties shells whose steal economics just changed.

Estimates and realized costs share one code path (`_walk`), so the
estimate is exact for the transfer that reserves immediately after
estimating — later reservations only push costs *up*, which is the
conservative direction for the steal gate.

schedlint: this is a sim module — no ambient time, no randomness; all
clocks are injected `now` parameters.
"""
from __future__ import annotations


class Link:
    """One directed edge (port->switch, switch->switch, or switch->port).

    `busy_until` is the serialization horizon: a new transfer starts no
    earlier than the previous one finished (store-and-forward, one
    in-flight frame per link — the FireSim-style bounded channel).
    `inflight` counts reserved-but-unreleased transfers occupying the
    bounded output buffer (`buffer` deep); estimates return `inf` while
    it is full.  `busy_ms`/`transfers`/`max_queue` are stats only.
    """

    __slots__ = ("src", "dst", "latency_ms", "bw_ms", "buffer",
                 "busy_until", "inflight", "busy_ms", "transfers",
                 "max_queue")

    def __init__(self, src: str, dst: str, latency_ms: float,
                 bw_ms: float, buffer: int):
        self.src = src
        self.dst = dst
        self.latency_ms = latency_ms
        self.bw_ms = bw_ms
        self.buffer = buffer
        self.busy_until = 0.0
        self.inflight = 0
        self.busy_ms = 0.0
        self.transfers = 0
        self.max_queue = 0

    @property
    def name(self) -> str:
        return f"{self.src}->{self.dst}"


class Transfer:
    """A realized (reserved) transfer: the receipt `reserve` returns.

    `total_ms` is what the mover pays end to end (`t_done - t_start`);
    `wait_ms` is the queueing share of it — time spent blocked behind
    earlier transfers before the first link even accepted the payload.
    """

    __slots__ = ("src", "dst", "payload", "t_start", "wait_ms",
                 "total_ms", "t_done", "route")

    def __init__(self, src, dst, payload, t_start, wait_ms, total_ms,
                 route):
        self.src = src
        self.dst = dst
        self.payload = payload
        self.t_start = t_start
        self.wait_ms = wait_ms
        self.total_ms = total_ms
        self.t_done = t_start + total_ms
        self.route = route


def _check_link_params(where: str, latency_ms, bw_ms, buffer) -> None:
    if not isinstance(latency_ms, (int, float)) or latency_ms < 0:
        raise ValueError(f"{where}: latency_ms must be a number >= 0, "
                         f"got {latency_ms!r}")
    if not isinstance(bw_ms, (int, float)) or bw_ms < 0:
        raise ValueError(f"{where}: bw_ms must be a number >= 0 "
                         f"(milliseconds per unit payload), got {bw_ms!r}")
    if not isinstance(buffer, int) or isinstance(buffer, bool) \
            or buffer < 1:
        raise ValueError(f"{where}: buffer must be an int >= 1, "
                         f"got {buffer!r}")


def validate_topology(topo: dict, shells) -> None:
    """Validate a topology JSON dict against a shell-name collection.

    Raises ValueError naming the offending key/pair — descriptor loads
    fail at `from_json` time, not later at steal time.  Constructing a
    `FabricNetwork.from_topology` performs the same checks; this is the
    load-time entry point `FabricDescriptor` uses.
    """
    FabricNetwork.from_topology(topo, shells)


class FabricNetwork:
    """Deterministic link-level interconnect model (or its uniform shim).

    Construct via `uniform` (scalar compatibility), `crossbar` (every
    shell on one switch), or `from_topology` (JSON multi-switch).
    """

    # -- construction --------------------------------------------------------

    def __init__(self):
        # built by the classmethods; direct construction is internal
        self._mode = "uniform"
        self._default = 0.0
        self._pairs: dict[tuple[str, str], float] = {}
        self._links: dict[tuple[str, str], Link] = {}
        self._routes: dict[tuple[str, str], tuple] = {}
        self._ports: dict[str, str] = {}
        self._active: list[Transfer] = []     # reserved, not yet released
        self._pending: list[Transfer] = []    # reserved since last drain
        self.version = 0                      # bumps on reserve/release

    @classmethod
    def uniform(cls, shells, default_ms: float = 0.0,
                pairs: dict | None = None) -> "FabricNetwork":
        """Degenerate topology: the old scalar model, byte-identical.

        `pairs` maps `(victim, thief)` tuples to per-pair costs (already
        parsed by `parse_transfer_pair`); everything else pays
        `default_ms`.  No links, no state, `version` never moves.
        """
        net = cls()
        net._default = default_ms
        net._pairs = dict(pairs or {})
        return net

    @classmethod
    def crossbar(cls, shells, latency_ms: float = 0.1,
                 bw_ms: float = 0.0, buffer: int = 4) -> "FabricNetwork":
        """Every shell on one switch — the default link topology."""
        return cls.from_topology({
            "switches": ["xbar"],
            "ports": {s: "xbar" for s in shells},
            "default_link": {"latency_ms": latency_ms, "bw_ms": bw_ms,
                             "buffer": buffer},
        }, shells)

    @classmethod
    def from_topology(cls, topo: dict, shells) -> "FabricNetwork":
        """Build (and fully validate) a link topology from JSON.

        Schema::

            {"switches": ["sw0", "sw1"],
             "ports":    {"<shell-or-port>": "<switch>", ...},
             "default_link": {"latency_ms": f, "bw_ms": f, "buffer": i},
             "links": [{"src": n, "dst": n, "latency_ms": f, "bw_ms": f,
                        "buffer": i, "duplex": true}, ...]}

        Every shell must have a port; extra port names (e.g. "ingress",
        consulted by ECT dispatch) are allowed.  A `links` entry whose
        endpoints are a port and its switch overrides that attachment's
        default parameters; switch-to-switch links exist only if listed
        (duplex by default).  Unreachable port pairs are an error here,
        not a surprise at steal time.
        """
        if not isinstance(topo, dict):
            raise ValueError(f"topology must be a dict, got {type(topo).__name__}")
        unknown = set(topo) - {"switches", "ports", "default_link", "links"}
        if unknown:
            raise ValueError(f"topology: unknown keys {sorted(unknown)}")
        switches = topo.get("switches")
        if not switches or not isinstance(switches, list) \
                or len(set(switches)) != len(switches) \
                or not all(isinstance(s, str) for s in switches):
            raise ValueError("topology: 'switches' must be a non-empty "
                             "list of unique strings")
        ports = topo.get("ports") or {}
        if not isinstance(ports, dict):
            raise ValueError("topology: 'ports' must be a dict "
                             "{port-name: switch}")
        swset = set(switches)
        for node, sw in sorted(ports.items()):
            if not isinstance(node, str) or node in swset:
                raise ValueError(f"topology: bad port name {node!r} "
                                 f"(must be a string, not a switch)")
            if sw not in swset:
                raise ValueError(f"topology: port {node!r} attaches to "
                                 f"unknown switch {sw!r} "
                                 f"(switches: {sorted(swset)})")
        missing = sorted(set(shells) - set(ports))
        if missing:
            raise ValueError(f"topology: shells {missing} have no port "
                             f"(every shell needs a 'ports' entry)")
        dflt = dict(topo.get("default_link")
                    or {"latency_ms": 0.1, "bw_ms": 0.0, "buffer": 4})
        dflt.setdefault("latency_ms", 0.1)
        dflt.setdefault("bw_ms", 0.0)
        dflt.setdefault("buffer", 4)
        _check_link_params("topology default_link", dflt["latency_ms"],
                           dflt["bw_ms"], dflt["buffer"])

        net = cls()
        net._mode = "links"
        net._ports = {str(k): str(v) for k, v in ports.items()}

        def add(src, dst, lat, bw, buf, where):
            if (src, dst) in net._links:
                raise ValueError(f"{where}: duplicate link "
                                 f"{src!r}->{dst!r}")
            net._links[(src, dst)] = Link(src, dst, float(lat),
                                          float(bw), buf)

        # port attachments: duplex links with default parameters
        for node, sw in sorted(net._ports.items()):
            add(node, sw, dflt["latency_ms"], dflt["bw_ms"],
                dflt["buffer"], "topology ports")
            add(sw, node, dflt["latency_ms"], dflt["bw_ms"],
                dflt["buffer"], "topology ports")

        nodes = swset | set(net._ports)
        for i, entry in enumerate(topo.get("links") or []):
            where = f"topology links[{i}]"
            if not isinstance(entry, dict):
                raise ValueError(f"{where}: must be a dict")
            src, dst = entry.get("src"), entry.get("dst")
            if src not in nodes or dst not in nodes or src == dst:
                raise ValueError(
                    f"{where}: pair {src!r}->{dst!r} must name two "
                    f"distinct declared nodes {sorted(nodes)}")
            lat = entry.get("latency_ms", dflt["latency_ms"])
            bw = entry.get("bw_ms", dflt["bw_ms"])
            buf = entry.get("buffer", dflt["buffer"])
            _check_link_params(where, lat, bw, buf)
            pairs = [(src, dst)]
            if entry.get("duplex", True):
                pairs.append((dst, src))
            for a, b in pairs:
                if (a, b) in net._links:
                    if a in swset and b in swset:
                        raise ValueError(f"{where}: duplicate link "
                                         f"{a!r}->{b!r}")
                    # port-attachment override
                    net._links[(a, b)] = Link(a, b, float(lat),
                                              float(bw), buf)
                else:
                    add(a, b, lat, bw, buf, where)

        # deterministic BFS over the switch graph, then precompute every
        # port-pair route; unreachable pairs fail here, at load time
        adj: dict[str, list[str]] = {s: [] for s in switches}
        for (a, b) in sorted(net._links):
            if a in swset and b in swset:
                adj[a].append(b)
        sw_path: dict[tuple[str, str], list[str]] = {}
        for start in switches:
            seen = {start: [start]}
            frontier = [start]
            while frontier:
                nxt = []
                for u in frontier:
                    for v in adj[u]:
                        if v not in seen:
                            seen[v] = seen[u] + [v]
                            nxt.append(v)
                frontier = nxt
            for end, path in seen.items():
                sw_path[(start, end)] = path
        port_names = sorted(net._ports)
        for a in port_names:
            for b in port_names:
                if a == b:
                    continue
                key = (net._ports[a], net._ports[b])
                if key not in sw_path:
                    raise ValueError(
                        f"topology: no switch path from {a!r} (on "
                        f"{key[0]!r}) to {b!r} (on {key[1]!r}) — add a "
                        f"'links' entry connecting the switches")
                path = sw_path[key]
                route = [net._links[(a, path[0])]]
                for u, v in zip(path, path[1:]):
                    route.append(net._links[(u, v)])
                route.append(net._links[(path[-1], b)])
                net._routes[(a, b)] = tuple(route)
        return net

    # -- introspection -------------------------------------------------------

    @property
    def active(self) -> bool:
        """True in links mode — False means the uniform scalar shim."""
        return self._mode == "links"

    @property
    def has_ingress(self) -> bool:
        """An explicit "ingress" port prices job *arrival* placement
        (ECT dispatch) in addition to cross-shell steals."""
        return "ingress" in self._ports

    @property
    def inflight(self) -> int:
        return len(self._active)

    def links(self):
        """Deterministically ordered link list (tests, stats)."""
        return [self._links[k] for k in sorted(self._links)]

    # -- cost model ----------------------------------------------------------

    def _walk(self, route, payload: float, now: float, loaded: bool,
              bounded: bool) -> float:
        """Store-and-forward end time of a `payload`-unit transfer
        entering `route` at `now`; `inf` if `bounded` and any buffer is
        full.  `loaded=False` ignores occupancy (the zero-load figure —
        exactly what the scalar model believed)."""
        t = now
        for link in route:
            if loaded:
                if bounded and link.inflight >= link.buffer:
                    return float("inf")
                start = link.busy_until if link.busy_until > t else t
            else:
                start = t
            t = start + link.latency_ms + payload * link.bw_ms
        return t

    def est_transfer_ms(self, src: str, dst: str, payload: float = 1.0,
                        now: float = 0.0, loaded: bool = True,
                        bounded: bool = True) -> float:
        """Estimated cost of moving `payload` units `src`->`dst` at `now`.

        Uniform mode: the scalar per-pair lookup, ignoring load and
        payload — byte-identical to the old `Fabric._transfer_ms`.
        Links mode: queue-aware store-and-forward walk; `inf` while a
        bounded buffer on the route is full (back off, thief).
        """
        if self._mode == "uniform":
            return self._pairs.get((src, dst), self._default)
        if src == dst:
            return 0.0
        end = self._walk(self._routes[(src, dst)], payload, now,
                         loaded, bounded)
        return end - now if end != float("inf") else end

    def reserve(self, src: str, dst: str, payload: float,
                now: float) -> Transfer:
        """Realize a transfer: occupy every link on the route and return
        the receipt.  The caller gates *before* reserving (a full buffer
        estimates `inf`), so reservation itself never refuses — an
        overcommitted link simply serializes, which is the cost the
        over-eager scalar model pays in `benchmarks/network_contention`.
        """
        if self._mode == "uniform":
            cost = self._pairs.get((src, dst), self._default)
            return Transfer(src, dst, payload, now, 0.0, cost, ())
        route = self._routes[(src, dst)]
        first = route[0]
        wait = first.busy_until - now if first.busy_until > now else 0.0
        t = now
        for link in route:
            start = link.busy_until if link.busy_until > t else t
            t = start + link.latency_ms + payload * link.bw_ms
            link.busy_until = t
            link.inflight += 1
            link.transfers += 1
            link.busy_ms += t - start
            if link.inflight > link.max_queue:
                link.max_queue = link.inflight
        tr = Transfer(src, dst, payload, now, wait, t - now, route)
        self._active.append(tr)
        self._pending.append(tr)
        self.version += 1
        return tr

    def advance(self, now: float) -> list[Transfer]:
        """Release every reserved transfer whose `t_done` has passed,
        freeing link buffer slots, and return them (oldest first).  The
        simulator calls this from "net" heap events; the daemon calls it
        each loop on wall clock."""
        if not self._active:
            return []
        done = [t for t in self._active if t.t_done <= now]
        if not done:
            return []
        self._active = [t for t in self._active if t.t_done > now]
        for tr in done:
            for link in tr.route:
                link.inflight -= 1
        self.version += 1
        done.sort(key=lambda t: (t.t_done, t.src, t.dst))
        return done

    def drain_releases(self) -> list[Transfer]:
        """Transfers reserved since the last drain — the simulator turns
        each into a timed "net" release event on its heap."""
        out, self._pending = self._pending, []
        return out

    # -- observability -------------------------------------------------------

    def gauges(self) -> dict:
        """Count-based link gauges (no clock needed): sampled by the
        flight recorder alongside occupancy/pending."""
        return {"links_busy": sum(1 for l in self._links.values()
                                  if l.inflight > 0),
                "transfers_inflight": len(self._active)}

    def stats(self) -> dict:
        """Per-link lifetime stats for `FlightRecorder.snapshot()`."""
        return {self._links[k].name: {
                    "transfers": self._links[k].transfers,
                    "busy_ms": self._links[k].busy_ms,
                    "max_queue": self._links[k].max_queue}
                for k in sorted(self._links)}
