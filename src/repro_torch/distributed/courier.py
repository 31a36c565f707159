"""Courier errors.

Holds only ``CourierClosed``, which the batching server raises once it is
stopped, and ``ServiceUnavailable``, which a replay table marked down
raises; the RPC transport of ``repro/distributed/courier.py`` comes with the
distributed slice.
"""


class CourierClosed(ConnectionError):
    """The peer closed the connection (server stopped, or vice versa)."""


class ServiceUnavailable(ConnectionError):
    """The service stayed unreachable past the reconnect deadline (its
    restart window exceeded the budget, or it is down for good) — or, when
    raised server-side, the service is marked down awaiting failover.  A
    ``ConnectionError`` subclass so degradation paths catch transport and
    application unavailability uniformly."""
