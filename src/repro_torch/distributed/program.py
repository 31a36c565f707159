"""Launchpad-lite (§2.4): a distributed program is a graph of nodes.

Nodes are constructed lazily from factories; edges are *handles* — from the
node's perspective a handle is indistinguishable from the object itself
(Launchpad's key property: local vs remote calls look identical).  Execution
is pluggable (``repro_torch.distributed.launchers``): the same graph runs on
threads (``local``) or on OS processes with courier RPC edges
(``multiprocess``), with no change to node code.

Node metadata (``Program.add_node``):

- ``role``: ``"worker"`` (a run loop the launcher schedules — actors,
  evaluators) or ``"service"`` (stateful, parent-resident, addressable by
  other nodes — replay shards, counters, variable sources).  A service whose
  instance defines ``run()`` additionally gets a parent-side thread (the
  learner is such a hybrid: it steps SGD *and* serves ``get_variables``).
- ``num_replicas``: expands the node into ``name/0 .. name/N-1`` replicas
  (actor pools, evaluator fleets); per-replica arguments are declared with
  the ``Replica`` wrapper and resolved at expansion time.
- ``interface``: the declared RPC surface — an allowlist of method names
  enforced both by the in-memory ``Handle`` and by the courier
  ``RemoteHandle``/``Server``, so moving a node across a process boundary
  never widens what its clients may call.

Handle pickling degrades gracefully: once a launcher has bound a courier
server to a node (``Program.bind_courier``), pickling any ``Handle`` to that
node yields a ``RemoteHandle`` RPC stub with identical call syntax; pickling
an unbound handle is a loud error rather than a silently broken proxy.
"""
from __future__ import annotations

import pickle
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

ROLES = ("worker", "service")


class Replica:
    """Per-replica argument: ``Replica(fn)`` is replaced by ``fn(i)`` for
    replica ``i`` when a replicated node is expanded (e.g. per-replica RNG
    seeds).  Resolution happens in the parent at ``add_node`` time, so the
    wrapped callable never needs to cross a process boundary."""

    def __init__(self, fn: Callable[[int], Any]):
        self.fn = fn

    def resolve(self, index: int) -> Any:
        return self.fn(index)


class Handle:
    """Lazy in-memory proxy to a node's constructed object (client side of an
    edge).  Pickling converts it to a courier ``RemoteHandle`` when the node
    has a bound courier server (see module docstring)."""

    def __init__(self, program: "Program", name: str):
        self._program = program
        self._name = name

    @property
    def node_name(self) -> str:
        return self._name

    def dereference(self):
        return self._program.resolve(self._name)

    def __getattr__(self, item):
        # method-call forwarding: handle.method(...) == object.method(...)
        # Dunder probes (copy.deepcopy, inspect) must NOT construct the node
        # as a side effect — report them absent instead.
        if item.startswith("__") and item.endswith("__"):
            raise AttributeError(item)
        node = self._program.node(self._name)
        if node.interface is not None and item not in node.interface:
            raise AttributeError(
                f"{item!r} is not in node {self._name!r}'s declared "
                f"interface {node.interface}")
        obj = self.dereference()
        return getattr(obj, item)

    def __reduce__(self):
        # Crossing a process boundary: degrade to an RPC stub bound to the
        # node's courier server, keeping call syntax identical.
        node = self._program.node(self._name)
        if node.courier_address is None:
            raise pickle.PicklingError(
                f"Handle to node {self._name!r} cannot cross a process "
                f"boundary: no courier server is bound to it (launchers "
                f"bind service nodes automatically; see Launcher.serve).")
        from repro_torch.distributed.courier import RemoteHandle
        return (RemoteHandle,
                (node.courier_address, self._name, node.interface,
                 node.courier_authkey))


class Node:
    def __init__(self, name: str, factory: Callable[..., Any],
                 args: tuple, kwargs: dict, role: str,
                 interface: Optional[Tuple[str, ...]] = None,
                 replica_index: Optional[int] = None,
                 group: Optional[str] = None):
        self.name = name
        self.factory = factory
        self.args = args
        self.kwargs = kwargs
        self.role = role
        self.interface = interface
        self.replica_index = replica_index
        self.group = group or name
        self.instance: Any = None
        # Where a launcher placed this node: "inline" (not launched yet or
        # constructed-only), "thread" (parent thread), "process" (child OS
        # process — parent-side resolve is forbidden).
        self.placement = "inline"
        # (host, port) + authkey of the courier server wrapping this node,
        # if any.
        self.courier_address: Optional[Tuple[str, int]] = None
        self.courier_authkey: Optional[bytes] = None

    @property
    def is_worker(self) -> bool:
        return self.role == "worker"


class Program:
    def __init__(self, name: str = "program"):
        self.name = name
        self._nodes: Dict[str, Node] = {}
        self._order: List[str] = []
        # Set by the assembly layer (see repro_torch.resilience.RestartPolicy):
        # launchers with elastic support respawn dead role="worker" nodes
        # under this policy instead of failing the whole run.
        self.restart_policy = None
        # Also set by assembly: the chaos policy (so the launcher-side
        # service watchdog can resolve kill schedules for role="service"
        # nodes — worker schedules resolve at assembly time instead) and
        # the cadence at which recoverable services are snapshotted for
        # failover.
        self.chaos_policy = None
        self.service_snapshot_period_s = 0.5
        # RLock: resolving a node dereferences its Handle arguments, which
        # re-enters resolve() on the same thread.
        self._lock = threading.RLock()

    def add_node(self, name: str, factory: Callable[..., Any], *args,
                 role: Optional[str] = None,
                 num_replicas: int = 1,
                 interface: Optional[Sequence[str]] = None,
                 is_worker: Optional[bool] = None,
                 **kwargs) -> Union[Handle, List[Handle]]:
        """Register a node (or ``num_replicas`` replicas of one).

        Returns a ``Handle`` — or a list of handles, one per replica, when
        ``num_replicas > 1`` (replicas are named ``name/0 .. name/N-1``).
        ``is_worker`` is the deprecated boolean spelling of
        ``role="worker"``.
        """
        if role is None:
            role = "worker" if is_worker else "service"
        elif is_worker is not None:
            raise ValueError("pass either role= or is_worker=, not both")
        if role not in ROLES:
            raise ValueError(f"role must be one of {ROLES}, got {role!r}")
        if num_replicas < 1:
            raise ValueError(f"num_replicas must be >= 1, got {num_replicas}")
        iface = tuple(interface) if interface is not None else None

        handles = []
        for i in range(num_replicas):
            args_i = tuple(a.resolve(i) if isinstance(a, Replica) else a
                           for a in args)
            kwargs_i = {k: (v.resolve(i) if isinstance(v, Replica) else v)
                        for k, v in kwargs.items()}
            if num_replicas == 1:
                self._register(Node(name, factory, args_i, kwargs_i, role,
                                    iface))
                return Handle(self, name)
            replica_name = f"{name}/{i}"
            self._register(Node(replica_name, factory, args_i, kwargs_i,
                                role, iface, replica_index=i, group=name))
            handles.append(Handle(self, replica_name))
        return handles

    def _register(self, node: Node):
        if node.name in self._nodes:
            raise ValueError(f"duplicate node {node.name!r}")
        self._nodes[node.name] = node
        self._order.append(node.name)

    def node(self, name: str) -> Node:
        return self._nodes[name]

    def resolve(self, name: str):
        with self._lock:
            node = self._nodes[name]
            if node.placement == "process":
                raise RuntimeError(
                    f"node {name!r} runs in a separate OS process; a "
                    f"parent-side resolve would construct a second instance. "
                    f"Talk to it through its handle / courier server.")
            if node.instance is None:
                args = [a.dereference() if isinstance(a, Handle) else a
                        for a in node.args]
                kwargs = {k: (v.dereference() if isinstance(v, Handle) else v)
                          for k, v in node.kwargs.items()}
                node.instance = node.factory(*args, **kwargs)
            return node.instance

    def bind_courier(self, name: str, address: Tuple[str, int],
                     authkey: Optional[bytes] = None):
        """Record the courier server (address + authkey) wrapping node
        ``name`` — from then on, pickling a Handle to it yields a
        ``RemoteHandle``."""
        self._nodes[name].courier_address = tuple(address)
        self._nodes[name].courier_authkey = authkey

    @property
    def nodes(self) -> List[Node]:
        return [self._nodes[n] for n in self._order]

